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
//   tmxusum   full, divided by l = p . 1, a column of the PV product
//   tb16sum   full, divided by l = sum of the rounded p
// with s = q k^T + mask (q comes pre-scaled), m the row's maximum over all
// n keys, and o = p [v, 1]: the output is o[:32] / o[32], or o[:32] / l for
// tfull and tb16sum. All sums are float32.
//
// Replaces tools/bench_softmax_variants.py:attn_kernel, a Pallas body that
// holds a whole (n, n) score tile per head. Here on the tile of the
// tensor-core attention kernels (attn_tc.cuh; B10, B4, B5, K2): per (item,
// head) and 64 queries a block of 4 warps, each warp 16 queries whose q
// fragments stay in registers, over 64-key tiles read by ldmatrix; every
// product on mma.sync m16n8k16 (bf16 operands, float32 accumulators).
//   - Head h of an item is the column slice [32h, 32h + 32) at row stride
//     heads * 32: bf16 tiles come straight from there through a 3-deep
//     cp.async ring; float32 tiles through registers, the next tile's loads
//     in flight while one is used, split into bf16 parts as they are stored.
//   - Variants with a row maximum take two walks over the keys: the first
//     finds each row's exact maximum (quad shuffles), the second forms p, so
//     p is rounded against the maximum where the tool and the plain version
//     round it. nosmax and nomax take one walk.
//   - The unfolded variants add the mask in float32 to the scores; the
//     folded ones add it by one more 16-deep k-step, q's column 32 set to 1
//     and k's to round_T(mask), as the tool's K = 33 contraction does.
//   - The denominator is a fifth n8 tile of the PV product, against a
//     column of ones; tfull and tb16sum sum their own l in registers.
//   - float32 operands as three bf16 parts (the six products of parts i, j
//     with i + j <= 2, each k-step summed apart: float32's 24 bits; two parts
//     hold every variant only within 2x of the GPU tests' 1e-5, and nosmax,
//     whose sums cross zero, not at all:
//     tests/test_torch_softmax_variants_design.py). The first walk takes the
//     maximum from one bf16 product unless p is linear in it (noexp): with
//     nothing rounded in float32, o is that of the exact maximum.
// Each variant is a compile-time branch of one kernel.
//
// Bound on the H100: operations, 2 n^2 (32 + 33) products per (item, head)
// (a 33rd column each side where the mask is folded) against O(n * 32)
// bytes, at 989 TFLOP/s in bf16 and a third of that in float32.
#include "small_tile.cuh"

namespace {

using namespace tc;

constexpr int kD = bt::kHeadDim;  // 32
constexpr int kNK = kD / 16;      // 16-deep steps of a score product

enum Variant {
  kNoSmax, kNoMax, kNoExp, kB16Exp, kFull, kKFold, kB16S, kB16SFold, kTFull, kTMxuSum, kTB16Sum,
  kVariants
};

#define BT_TRAIT template <int V> __host__ __device__ constexpr bool
BT_TRAIT folded() { return V == kKFold || V == kB16S || V == kB16SFold; }
BT_TRAIT rounded_scores() { return V == kB16S || V == kB16SFold; }
BT_TRAIT has_max() { return V != kNoSmax && V != kNoMax; }
BT_TRAIT own_sum() { return V == kTFull || V == kTB16Sum; }
#undef BT_TRAIT

// Operand parts (see above), and those of the first walk's scores.
template <typename T> __host__ __device__ constexpr int parts() { return mm::full_parts<T>(); }
template <typename T, int V> __host__ __device__ constexpr int max_parts() {
  return V == kNoExp ? parts<T>() : 1;
}

// A fragments (P parts, 16-deep steps) of rows row0 .. row0 + 15 of the
// matrix `src` (row stride ld, kD columns), zeros past n.
template <typename T, int P>
__device__ __forceinline__ void load_q(uint32_t (&a)[P][kNK][4], const T* __restrict__ src,
                                       int ld, int row0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk) {
    uint32_t r[P][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      const T* p = src + (size_t)(row < n ? row : 0) * ld;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 x = row < n ? load_pair(p, 8 * kk + 4 * half + t) : make_float2(0.f, 0.f);
        st::set_parts<P>(r, 2 * half + h, x.x, x.y);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[p][kk][i] = r[p][i];
  }
}

// The key tiles of one walk (k, and with WITH_V v: rows of kD at row stride
// ld, zeros past n) through shared memory, P bf16 parts a tile: the tiles of
// buffer b are ks[b P .. b P + P - 1] (vs likewise). at(it) makes tile it
// visible to the block and returns its buffer; finish() lets the next walk
// reuse the buffers.
template <typename T, int P, bool WITH_V> struct Ring;

// bf16: a cp.async ring of kStages buffers; tile it + kStages - 1 is staged
// while tile it is used, and the one barrier per tile both publishes tile it
// and frees the buffer the next copy overwrites.
template <bool WITH_V> struct Ring<bf16, 1, WITH_V> {
  static constexpr int S = kStages;
  Tile<kD>*ks, *vs;
  const bf16 *k, *v;
  int ld, n, tiles;

  __device__ __forceinline__ void issue(int it) {
    stage_strided<kD>(ks[it % S], k, ld, it * kTile, n);
    if constexpr (WITH_V) stage_strided<kD>(vs[it % S], v, ld, it * kTile, n);
  }
  __device__ __forceinline__ void begin() {
#pragma unroll
    for (int b = 0; b < S - 1; ++b) {
      if (b < tiles) issue(b);
      bt::cp_async_commit();
    }
  }
  __device__ __forceinline__ int at(int it) {
    bt::cp_async_wait<S - 2>();
    __syncthreads();
    if (it + S - 1 < tiles) issue(it + S - 1);
    bt::cp_async_commit();
    return it % S;
  }
  __device__ __forceinline__ void finish() {
    bt::cp_async_wait<0>();
    __syncthreads();
  }
};

// float32: two buffers and one tile in registers on its way there (its
// loads in flight while the tile before is used), split into P parts as it
// is stored. at(it): a barrier (tile it visible, the other buffer free),
// then tile it + 1 from the registers into the other buffer and the loads
// of tile it + 2.
template <int P, bool WITH_V> struct Ring<float, P, WITH_V> {
  static constexpr int S = 2;
  static constexpr int kPer = kTile * kD / 4 / kThreads;  // float4 a thread and tensor
  Tile<kD>*ks, *vs;
  const float *k, *v;
  int ld, n, tiles;
  float4 rk[kPer], rv[WITH_V ? kPer : 1];

  __device__ __forceinline__ void load(int it) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads, r = it * kTile + e / (kD / 4), c = 4 * (e % (kD / 4));
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      rk[i] = r < n ? *reinterpret_cast<const float4*>(k + (size_t)r * ld + c) : z;
      if constexpr (WITH_V) rv[i] = r < n ? *reinterpret_cast<const float4*>(v + (size_t)r * ld + c) : z;
    }
  }
  static __device__ __forceinline__ void put(Tile<kD>* tl, int r, int c, float4 x) {
    const float v[4] = {x.x, x.y, x.z, x.w};
    mm::store4<P>(&tl[0][r][c], kTile * (kD + 8), v);
  }
  __device__ __forceinline__ void write(int buf) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e / (kD / 4), c = 4 * (e % (kD / 4));
      put(ks + buf * P, r, c, rk[i]);
      if constexpr (WITH_V) put(vs + buf * P, r, c, rv[i]);
    }
  }
  __device__ __forceinline__ void begin() {
    load(0);
    write(0);
    if (tiles > 1) load(1);
  }
  __device__ __forceinline__ int at(int it) {
    __syncthreads();
    if (it + 1 < tiles) write((it + 1) % S);
    if (it + 2 < tiles) load(it + 2);
    return it % S;
  }
  __device__ __forceinline__ void finish() { __syncthreads(); }
};

// s = the warp's 16 queries (parts qa; PS of them, 1 or P) times the 64 keys
// of tile k0 (PS parts), plus the key mask, rounded to T where the variant
// rounds the scores. Folded: the mask as one more k-step, columns 0 .. PS - 1
// of its A fragment 1 and of its B fragment the parts of round_T(mask).
template <typename T, int V, int PS, int P>
__device__ __forceinline__ void masked_scores(float (&s)[8][4], const uint32_t (&qa)[P][kNK][4],
                                              const Tile<kD>* tl, const float* __restrict__ mask,
                                              int k0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the tile's mask values first, so that their loads are in flight during
  // the product: folded, key 8j + g of B's column g; else keys 8j + 2t + e
  float mk[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + (folded<V>() ? g : 2 * t + e);
      mk[j][e] = (folded<V>() && e) || key >= n ? 0.f : mask[key];
    }
  if constexpr (PS == 1) {
    product_nt<kD>(s, qa[0], tl[0]);
  } else {
    scores<kD, PS>(s, qa, tl);
  }
  if constexpr (folded<V>()) {
    constexpr uint32_t kOne = 0x3f80u;  // bf16 1.0
    const uint32_t ones = t == 0 ? (kOne | (PS > 1 ? kOne << 16 : 0u)) : t == 1 && PS > 2 ? kOne : 0u;
    const uint32_t a[4] = {ones, ones, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x = bt::round_to<T>(mk[j][0]), mp[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < PS; ++p) {
        mp[p] = bt::round_to<bf16>(x);
        x -= mp[p];
      }
      // rows 0 .. PS - 1 of this key's column: lane t holds rows 2t, 2t + 1
      const uint32_t b0 = t == 0 ? bt::pack_bf16(mp[0], mp[1]) : t == 1 ? bt::pack_bf16(mp[2], 0.f)
                                                                        : 0u;
      bt::mma_bf16(s[j], a, b0, 0u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] += mk[j][e];
        s[j][2 + e] += mk[j][e];
      }
  }
  if constexpr (rounded_scores<V>()) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = bt::round_to<T>(s[j][x]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    attn_variant_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ mask, T* __restrict__ out, int n, int gh) {
  constexpr int P = parts<T>(), PM = max_parts<T, V>();
  extern __shared__ __align__(16) unsigned char smem_b[];
  Tile<kD>* ks = reinterpret_cast<Tile<kD>*>(smem_b);  // [stages][P]
  Tile<kD>* vs = ks + Ring<T, P, true>::S * P;
  const int bh = blockIdx.x, item = bh / gh, h = bh % gh, ld = gh * kD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kRows + 16 * (threadIdx.x >> 5);
  const size_t base = (size_t)item * n * ld + h * kD;
  const int tiles = (n + kTile - 1) / kTile;
  uint32_t qa[P][kNK][4];
  load_q<T, P>(qa, q + base, ld, row0, n);

  float m[2] = {0.f, 0.f};
  if constexpr (has_max<V>()) {  // walk 1: each row's maximum
    m[0] = m[1] = -INFINITY;
    Ring<T, PM, false> ring{ks, nullptr, k + base, nullptr, ld, n, tiles};
    ring.begin();
    for (int it = 0; it < tiles; ++it) {
      const int buf = ring.at(it), k0 = it * kTile;
      float s[8][4];
      masked_scores<T, V, PM, P>(s, qa, ks + buf * PM, mask, k0, n);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * j + 2 * t + e < n) {
            m[0] = fmaxf(m[0], s[j][e]);
            m[1] = fmaxf(m[1], s[j][2 + e]);
          }
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    ring.finish();  // every warp is done with the buffers walk 2 restages
  }

  // walk 2: p, l and o = P [V, 1]
  Ring<T, P, true> ring{ks, vs, k + base, v + base, ld, n, tiles};
  ring.begin();
  // B fragments of a column of ones (column 0 of an n8 tile): lane 4g + t
  // holds rows 2t, 2t + 1 (and + 8) of column g
  const uint32_t ones = g == 0 ? 0x3f803f80u : 0u;
  float acc[kD / 8][4] = {}, den[4] = {0.f, 0.f, 0.f, 0.f};
  float l[2] = {0.f, 0.f};
  for (int it = 0; it < tiles; ++it) {
    const int buf = ring.at(it), k0 = it * kTile;
    float s[8][4];
    masked_scores<T, V, P, P>(s, qa, ks + buf * P, mask, k0, n);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = k0 + 8 * j + 2 * t + e < n;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float x = s[j][2 * hh + e];
          float p;
          if constexpr (V == kNoSmax) p = x;
          else if constexpr (V == kNoMax) p = fast_exp2(x);
          else if constexpr (V == kNoExp) p = x - m[hh];
          else if constexpr (V == kB16Exp) p = fast_exp2(bt::round_to<T>(x - m[hh]));
          else p = fast_exp2(x - m[hh]);
          p = in ? p : 0.f;
          if constexpr (V == kTFull) l[hh] += p;
          if constexpr (V == kTB16Sum) l[hh] += bt::round_to<T>(p);
          s[j][2 * hh + e] = p;
        }
      }
    uint32_t pa[P][4][4];
    to_parts<P>(pa, s);  // bf16: round_T(p)
    accumulate<kD, P>(acc, pa, vs + buf * P);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // float32: each 16-key step's sum in fresh accumulators, added in
      // float32, as mm::mma_parts sums P V (nosmax's cancelling row sums)
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = P - 1; p >= 0; --p) bt::mma_bf16(P > 1 ? d : den, pa[p][kk], ones, ones);
      if constexpr (P > 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) den[e] += d[e];
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    // the ones column's sums sit in the quad's first lane
    const float div = own_sum<V>() ? quad_sum(l[hh]) : __shfl_sync(0xffffffffu, den[2 * hh], lane & ~3);
    const int r = row0 + g + 8 * hh;
    if (r >= n) continue;
    T* dst = out + base + (size_t)r * ld;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c)
      store_pair(dst + 8 * c + 2 * t, acc[c][2 * hh] / div, acc[c][2 * hh + 1] / div);
  }
}

template <typename T, int V>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int items, int n, int gh, cudaStream_t stream) {
  constexpr int P = parts<T>();
  constexpr size_t smem = 2 * Ring<T, P, true>::S * P * sizeof(Tile<kD>);
  auto kernel = attn_variant_kernel<T, V>;
  cudaError_t err = bt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(items * gh, (n + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
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
// (items, n, gh * 32), 16-byte aligned (else cudaErrorInvalidValue); mask
// (n) float32: the additive key mask, or for the folded variants (5, 6, 7)
// the mask column, which the kernel rounds to the dtype. variant: 0 nosmax,
// 1 nomax, 2 noexp, 3 b16exp, 4 full, 5 kfold, 6 b16s, 7 b16sfold, 8 tfull,
// 9 tmxusum, 10 tb16sum.
extern "C" int bt_attn_variant(int dtype, int variant, const void* q, const void* k,
                               const void* v, const void* mask, void* out, int items, int n,
                               int gh, void* stream) {
  if (items <= 0 || n <= 0) return 0;
  if (gh < 1 || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0 ? dispatch<float>(variant, q, k, v, mask, out, items, n, gh, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(variant, q, k, v, mask, out, items, n, gh, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
