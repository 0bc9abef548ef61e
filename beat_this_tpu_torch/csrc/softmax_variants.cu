// Attention forward over (items, n, heads * 32), heads as column slices of
// 32, with the softmax passes varied one at a time, to see what each pass
// (key mask, row maximum, exp2, row sum) costs inside an attention kernel:
//
//   nosmax    p = round_T(s)                          no softmax at all
//   nomax     p = round_T(exp2(s))                    no row maximum
//   noexp     p = round_T(s - m)                      no exp2
//   b16exp    p = round_T(exp2(round_T(s - m)))       exp2 of a rounded argument
//   full      p = round_T(exp2(s - m))
//   kfold     full, with the key mask inside the score product: a 33rd
//             column, 1 on q and round_T(mask) on k
//   b16s, b16sfold   kfold with the score rounded to T before max and exp2
//             (the tool folds the mask for both, so they are one function)
//   tfull     full, divided by l = sum of the unrounded p
//   tmxusum   full, divided by l = p . 1, a further column of the PV product
//   tb16sum   full, divided by l = sum of the rounded p
// with s = q k^T + mask (q comes pre-scaled), m the row maximum, and
// o = p [v, 1]: the output is o[:32] / o[32], or o[:32] / l for the t*
// variants. All sums are float32.
//
// Replaces tools/bench_softmax_variants.py:attn_kernel, a Pallas body that
// holds a whole (n, n) score tile per head. Here, as in the time-axis
// attention of fused_time.cu: per (item * head, 128 queries), one query per
// thread with its q row and accumulators in registers, over 64-key tiles
// staged in shared memory as float32. Where a variant has a row maximum and
// an exp2, the maximum runs online, key by key: a key that raises it
// rescales what was summed so far (the same sum up to the rounding of p
// against a running maximum; after the first keys of a row that is rare, and
// the kernel's code stays small, which its 22 instantiations need to build
// in seconds); `noexp` is not linear in its maximum once p is rounded, so it
// finds m in a first pass over the keys (the score product twice); `nomax`
// and `nosmax` have no maximum at all.
//
// Bound on the H100: arithmetic, 2 n^2 (33 + 33) FLOP per (item, head)
// against O(n * 32) bytes. Products are float32 FMAs on the SIMT cores, so
// unlike on a matrix unit the passes are not hidden behind the products.
#include "common.cuh"

namespace {

constexpr int kQT = 128;  // queries per block, one per thread
constexpr int kKT = 64;   // keys per staged tile
constexpr int kD = bt::kHeadDim;

enum Variant {
  kNoSmax, kNoMax, kNoExp, kB16Exp, kFull, kKFold, kB16S, kB16SFold, kTFull, kTMxuSum, kTB16Sum,
  kVariants
};

#define BT_TRAIT template <int V> __host__ __device__ constexpr bool
BT_TRAIT folded() { return V == kKFold || V == kB16S || V == kB16SFold; }
BT_TRAIT rounded_scores() { return V == kB16S || V == kB16SFold; }
BT_TRAIT has_max() { return V != kNoSmax && V != kNoMax; }
BT_TRAIT online() { return has_max<V>() && V != kNoExp; }
BT_TRAIT own_sum() { return V == kTFull || V == kTMxuSum || V == kTB16Sum; }
#undef BT_TRAIT

// ks[j] = key row k0 + j of head h, ms[j] its mask value (zeros past n);
// with `vs`, also the value rows. Ends with a barrier.
template <typename T, int V>
__device__ __forceinline__ void stage(float (*ks)[kD], float (*vs)[kD], float* ms,
                                      const T* __restrict__ k, const T* __restrict__ v,
                                      const float* __restrict__ mask, size_t base, int ldx, int k0,
                                      int n) {
  for (int e = threadIdx.x; e < kKT * kD; e += kQT) {
    const int r = e / kD, d = e % kD;
    const bool ok = k0 + r < n;
    ks[r][d] = ok ? bt::to_f(k[base + (size_t)(k0 + r) * ldx + d]) : 0.f;
    if (vs != nullptr) vs[r][d] = ok ? bt::to_f(v[base + (size_t)(k0 + r) * ldx + d]) : 0.f;
  }
  for (int r = threadIdx.x; r < kKT; r += kQT) {
    const float mv = k0 + r < n ? mask[k0 + r] : 0.f;
    ms[r] = folded<V>() ? bt::round_to<T>(mv) : mv;
  }
  __syncthreads();
}

// The masked score of key j: the mask added to the product, or (folded) its
// last term, q's column of ones times the mask column.
template <typename T, int V>
__device__ __forceinline__ float score(const float (&qr)[kD], const float* kr, float mv) {
  float a = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) a += qr[d] * kr[d];
  a = folded<V>() ? fmaf(1.f, mv, a) : a + mv;
  return rounded_scores<V>() ? bt::round_to<T>(a) : a;
}

template <typename T, int V>
__global__ void __launch_bounds__(kQT)
    attn_variant_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ mask, T* __restrict__ out, int n, int gh) {
  __shared__ float ks[kKT][kD];
  __shared__ float vs[kKT][kD];
  __shared__ float ms[kKT];
  const int bh = blockIdx.x, item = bh / gh, h = bh % gh, ldx = gh * kD;
  const int t = blockIdx.y * kQT + threadIdx.x;
  const size_t base = (size_t)item * n * ldx + h * kD;
  float qr[kD], acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = t < n ? bt::to_f(q[base + (size_t)t * ldx + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  if constexpr (V == kNoExp) {
    for (int k0 = 0; k0 < n; k0 += kKT) {
      stage<T, V>(ks, nullptr, ms, k, v, mask, base, ldx, k0, n);
      const int kn = min(kKT, n - k0);
      for (int j = 0; j < kn; ++j) m = fmaxf(m, score<T, V>(qr, ks[j], ms[j]));
      __syncthreads();
    }
  }
  float den = 0.f;  // the PV product's column of ones
  float l = 0.f;    // the t* variants' own row sum
  for (int k0 = 0; k0 < n; k0 += kKT) {
    stage<T, V>(ks, vs, ms, k, v, mask, base, ldx, k0, n);
    const int kn = min(kKT, n - k0);
#pragma unroll 4
    for (int j = 0; j < kn; ++j) {
      const float s = score<T, V>(qr, ks[j], ms[j]);
      if constexpr (online<V>()) {
        if (s > m) {  // a new row maximum: rescale what was summed against the old one
          const float corr = exp2f(m - s);
          den *= corr;
          l *= corr;
#pragma unroll
          for (int d = 0; d < kD; ++d) acc[d] *= corr;
          m = s;
        }
      }
      float p32;
      if constexpr (V == kNoSmax) p32 = s;
      else if constexpr (V == kNoMax) p32 = exp2f(s);
      else if constexpr (V == kNoExp) p32 = s - m;
      else if constexpr (V == kB16Exp) p32 = exp2f(bt::round_to<T>(s - m));
      else p32 = exp2f(s - m);
      const float p = bt::round_to<T>(p32);
      if constexpr (V == kTFull) l += p32;
      if constexpr (V == kTB16Sum) l += p;
      if constexpr (V == kTMxuSum) l = fmaf(p, 1.f, l);
      den = fmaf(p, 1.f, den);
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] += p * vs[j][d];
    }
    __syncthreads();
  }
  if (t >= n) return;
  const float div = own_sum<V>() ? l : den;
  T* dst = out + base + (size_t)t * ldx;
#pragma unroll
  for (int d = 0; d < kD; ++d) dst[d] = bt::from_f<T>(acc[d] / div);
}

template <typename T, int V>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int items, int n, int gh, cudaStream_t stream) {
  const dim3 grid(items * gh, (n + kQT - 1) / kQT);
  attn_variant_kernel<T, V><<<grid, kQT, 0, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                      (const float*)mask, (T*)out, n, gh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int variant, const void* q, const void* k, const void* v, const void* mask,
                     void* out, int items, int n, int gh, cudaStream_t s) {
#define BT_CASE(VV) \
  case VV: return launch<T, VV>(q, k, v, mask, out, items, n, gh, s);
  switch (variant) {
    BT_CASE(kNoSmax)
    BT_CASE(kNoMax)
    BT_CASE(kNoExp)
    BT_CASE(kB16Exp)
    BT_CASE(kFull)
    BT_CASE(kKFold)
    BT_CASE(kB16S)
    BT_CASE(kB16SFold)
    BT_CASE(kTFull)
    BT_CASE(kTMxuSum)
    BT_CASE(kTB16Sum)
    default: return cudaErrorInvalidValue;
  }
#undef BT_CASE
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 for q (pre-scaled), k, v and out
// (items, n, gh * 32); mask (n) float32: the additive key mask, or for the
// folded variants (5, 6, 7) the mask column, which the kernel rounds to the
// dtype. variant: 0 nosmax, 1 nomax, 2 noexp, 3 b16exp, 4 full, 5 kfold,
// 6 b16s, 7 b16sfold, 8 tfull, 9 tmxusum, 10 tb16sum.
extern "C" int bt_attn_variant(int dtype, int variant, const void* q, const void* k,
                               const void* v, const void* mask, void* out, int items, int n,
                               int gh, void* stream) {
  if (items <= 0 || n <= 0) return 0;
  if (gh < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0 ? dispatch<float>(variant, q, k, v, mask, out, items, n, gh, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(variant, q, k, v, mask, out, items, n, gh, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
