// Exact-softmax attention over (items, F, D) for short sequences (F divides
// 32: the frontend's frequency axis, 32 / 16 / 8 bins), heads folded into
// the items, with the rotation of q and k inside, forward and backward:
//   o = drop_p(softmax(rope(q) rope(k)^T D^-0.5)) v     per item,
// the softmax in base 2 with D^-0.5 log2(e) folded into q before q is
// rounded, dropout on the probabilities from Philox (philox.cuh) by the
// coordinates (item / heads, item % heads, query, key), the normalizer
// summed over the undropped p.
//
// Replaces beat_this_tpu/ops/small_attention.py:_small_attn_kernel and
// :_small_attn_bwd_kernel, which pack 128 / F items into one masked
// 128 x 128 score matrix for the TPU's matrix unit. Here nothing off the
// block diagonal is computed: a block of 128 threads holds 128 / F whole
// items, one thread per (item, row). Each thread loads its own rows of q,
// k, v (and dout) with 16-byte loads, rotates, and shares them through
// shared memory (each item's rows padded by 4 floats, so the items of a
// warp fall into different banks).
//   forward:  the thread's F scores stay in registers; two-pass softmax.
//   backward: a row pass (the thread as query i: p, dp, delta, ds, dq) that
//     leaves the row's max, sum, delta and keep bits in shared memory, then
//     a column pass (the thread as key j: dk and dv as sums over the item's
//     queries, recomputing p from the saved max and sum). No atomics: two
//     runs give the same bits.
//
// Bound on the H100: bytes (each of q, k, v, o read or written once against
// 4 F D multiply-adds per row). Products are float32 FMAs on the SIMT cores;
// bfloat16 values are widened on load and rounded where the TPU kernels
// round (q and k after the rotation, the dropped p, ds, o, dq, dk, dv).
#include "attn_rows.cuh"

namespace {

constexpr int kNT = 128;  // threads, and (item, row) pairs, per block

// Floats of one item's F rows in a shared array, and of the array.
template <int F, int D> __host__ __device__ constexpr int item_ld() { return F * D + 4; }
template <int F, int D> __host__ __device__ constexpr int tile_floats() {
  return (kNT / F) * item_ld<F, D>();
}

template <int D> __device__ __forceinline__ float dot(const float (&a)[D], const float* b) {
  const float4* p = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 v = p[i];
    s += a[4 * i] * v.x;
    s += a[4 * i + 1] * v.y;
    s += a[4 * i + 2] * v.z;
    s += a[4 * i + 3] * v.w;
  }
  return s;
}

// acc += w * b[0..D)
template <int D> __device__ __forceinline__ void axpy(float (&acc)[D], float w, const float* b) {
  const float4* p = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 v = p[i];
    acc[4 * i] += w * v.x;
    acc[4 * i + 1] += w * v.y;
    acc[4 * i + 2] += w * v.z;
    acc[4 * i + 3] += w * v.w;
  }
}

// The keep factors of query `row`'s F keys, and their bits (bit j: key j kept).
template <int F>
__device__ __forceinline__ uint32_t keep_row(const bt::Dropout& drop, uint32_t item,
                                             uint32_t head, uint32_t row, float (&f)[F]) {
  uint32_t bits = 0;
#pragma unroll
  for (int j4 = 0; j4 < (F + 3) / 4; ++j4) {
    float g[4];
    bt::keep4(drop, bt::kSiteAttnProbs, item, head, row, j4, g);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * j4 + e < F) {
        f[4 * j4 + e] = g[e];
        bits |= (uint32_t)(g[e] != 0.f) << (4 * j4 + e);
      }
  }
  return bits;
}

template <int F, int D, typename T>
__global__ void __launch_bounds__(kNT)
    small_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ cosv, const float* __restrict__ sinv,
                     T* __restrict__ o, int64_t rows, int heads, bt::Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + tile_floats<F, D>();
  const int tid = threadIdx.x, a = tid / F, i = tid % F;
  const int64_t row = (int64_t)blockIdx.x * kNT + tid;
  const bool ok = row < rows;
  const int at = a * item_ld<F, D>();
  float qr[D], x[D];
  bt::zero_row(qr);
  bt::zero_row(x);
  if (ok) {
    bt::load_rotated<D, T>(qr, q + row * D, cosv, sinv, i, bt::qscale<D>());
    bt::load_rotated<D, T>(x, k + row * D, cosv, sinv, i, 1.f);
  }
  bt::store_row<D>(ks + at + i * D, x);
  bt::zero_row(x);
  if (ok) bt::load_row<D>(x, v + row * D);
  bt::store_row<D>(vs + at + i * D, x);
  __syncthreads();
  if (!ok) return;

  float s[F], f[F];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < F; ++j) {
    s[j] = dot<D>(qr, ks + at + j * D);
    m = fmaxf(m, s[j]);
  }
  const int64_t item = row / F;
  keep_row<F>(drop, (uint32_t)(item / heads), (uint32_t)(item % heads), i, f);
  float l = 0.f, acc[D];
  bt::zero_row(acc);
#pragma unroll
  for (int j = 0; j < F; ++j) {
    const float p = exp2f(s[j] - m);
    l += p;
    axpy<D>(acc, bt::round_to<T>(p * f[j]), vs + at + j * D);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] /= l;
  bt::store_row<D>(o + row * D, acc);
}

template <int F, int D, typename T>
__global__ void __launch_bounds__(kNT)
    small_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ cosv, const float* __restrict__ sinv,
                     const T* __restrict__ dout, T* __restrict__ dq_out, T* __restrict__ dk_out,
                     T* __restrict__ dv_out, int64_t rows, int heads, bt::Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  constexpr int tf = tile_floats<F, D>();
  float* ks = smem;        // rotated k, rounded
  float* vs = ks + tf;
  float* qss = vs + tf;    // rotated q times D^-0.5 log2(e), rounded: the scores' operand
  float* qus = qss + tf;   // rotated q, rounded: the dk product's operand
  float* dos = qus + tf;   // dout
  float* ms = dos + tf;    // per row: max score, softmax sum, delta
  float* ls = ms + kNT;
  float* dls = ls + kNT;
  uint32_t* kbits = reinterpret_cast<uint32_t*>(dls + kNT);  // per row: keep bits of its keys
  const int tid = threadIdx.x, a = tid / F, i = tid % F;
  const int64_t row = (int64_t)blockIdx.x * kNT + tid;
  const bool ok = row < rows;
  const int at = a * item_ld<F, D>(), mine = at + i * D;

  float qs[D], dor[D];
  {
    float x[D];
    bt::zero_row(x);
    if (ok) {
      bt::load_row<D>(x, q + row * D);
      bt::rope<D>(x, cosv, sinv, i);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qs[d] = bt::round_to<T>(x[d] * bt::qscale<D>());
      x[d] = bt::round_to<T>(x[d]);
    }
    bt::store_row<D>(qus + mine, x);
    bt::store_row<D>(qss + mine, qs);
    bt::zero_row(x);
    if (ok) bt::load_rotated<D, T>(x, k + row * D, cosv, sinv, i, 1.f);
    bt::store_row<D>(ks + mine, x);
    bt::zero_row(x);
    if (ok) bt::load_row<D>(x, v + row * D);
    bt::store_row<D>(vs + mine, x);
    bt::zero_row(dor);
    if (ok) bt::load_row<D>(dor, dout + row * D);
    bt::store_row<D>(dos + mine, dor);
  }
  __syncthreads();

  const int64_t item = row / F;
  const uint32_t ditem = (uint32_t)(item / heads), dhead = (uint32_t)(item % heads);
  if (ok) {  // the thread as query i
    float p[F], f[F];
    float m = -INFINITY, l = 0.f;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      p[j] = dot<D>(qs, ks + at + j * D);
      m = fmaxf(m, p[j]);
    }
#pragma unroll
    for (int j = 0; j < F; ++j) {
      p[j] = exp2f(p[j] - m);
      l += p[j];
    }
    kbits[tid] = keep_row<F>(drop, ditem, dhead, i, f);
    float delta = 0.f;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      p[j] /= l;
      f[j] *= dot<D>(dor, vs + at + j * D);  // dp times the keep factor
      delta += p[j] * f[j];
    }
    float dq[D];
    bt::zero_row(dq);
#pragma unroll
    for (int j = 0; j < F; ++j)
      axpy<D>(dq, bt::round_to<T>(p[j] * (f[j] - delta)), ks + at + j * D);
    bt::rope_inv_scaled<D>(dq, cosv, sinv, i, bt::scale<D>());
    bt::store_row<D>(dq_out + row * D, dq);
    ms[tid] = m;
    ls[tid] = l;
    dls[tid] = delta;
  }
  __syncthreads();
  if (!ok) return;

  // the thread as key j = i: sums over the item's queries r
  float kr[D], vr[D], dk[D], dv[D];
  bt::load_row<D>(kr, ks + mine);
  bt::load_row<D>(vr, vs + mine);
  bt::zero_row(dk);
  bt::zero_row(dv);
#pragma unroll 4
  for (int r = 0; r < F; ++r) {
    const int qrow = tid - i + r;
    const float* dorow = dos + at + r * D;
    const float p = exp2f(dot<D>(kr, qss + at + r * D) - ms[qrow]) / ls[qrow];
    const float f = !drop.on ? 1.f : ((kbits[qrow] >> i) & 1u) ? drop.scale : 0.f;
    const float dp = dot<D>(vr, dorow) * f;
    axpy<D>(dv, bt::round_to<T>(p * f), dorow);
    axpy<D>(dk, bt::round_to<T>(p * (dp - dls[qrow])), qus + at + r * D);
  }
  bt::rope_inv_scaled<D>(dk, cosv, sinv, i, bt::scale<D>());
  bt::store_row<D>(dk_out + row * D, dk);
  bt::store_row<D>(dv_out + row * D, dv);
}

template <int F, int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* cosv,
                       const void* sinv, void* o, int64_t items, int heads, bt::Dropout drop,
                       cudaStream_t stream) {
  const int64_t rows = items * F;
  const size_t smem = sizeof(float) * 2 * tile_floats<F, D>();
  auto kern = small_fwd_kernel<F, D, T>;
  cudaError_t err = bt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((rows + kNT - 1) / kNT), kNT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)cosv, (const float*)sinv, (T*)o, rows,
      heads, drop);
  return cudaGetLastError();
}

template <int F, int D, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* cosv,
                       const void* sinv, const void* dout, void* dq, void* dk, void* dv,
                       int64_t items, int heads, bt::Dropout drop, cudaStream_t stream) {
  const int64_t rows = items * F;
  const size_t smem = sizeof(float) * (5 * tile_floats<F, D>() + 4 * kNT);
  auto kern = small_bwd_kernel<F, D, T>;
  cudaError_t err = bt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((rows + kNT - 1) / kNT), kNT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)cosv, (const float*)sinv,
      (const T*)dout, (T*)dq, (T*)dk, (T*)dv, rows, heads, drop);
  return cudaGetLastError();
}

// CALL(F, D, T) for the runtime sequence length, head width and dtype code.
#define BT_SMALL_F(CALL, DD, TT)              \
  switch (F) {                                \
    case 1: return (int)CALL(1, DD, TT);      \
    case 2: return (int)CALL(2, DD, TT);      \
    case 4: return (int)CALL(4, DD, TT);      \
    case 8: return (int)CALL(8, DD, TT);      \
    case 16: return (int)CALL(16, DD, TT);    \
    case 32: return (int)CALL(32, DD, TT);    \
    default: return (int)cudaErrorInvalidValue; \
  }
#define BT_SMALL_DISPATCH(CALL)                                      \
  if (dtype == 0 && D == 16) BT_SMALL_F(CALL, 16, float)             \
  if (dtype == 0 && D == 32) BT_SMALL_F(CALL, 32, float)             \
  if (dtype == 1 && D == 16) BT_SMALL_F(CALL, 16, __nv_bfloat16)     \
  if (dtype == 1 && D == 32) BT_SMALL_F(CALL, 32, __nv_bfloat16)     \
  return (int)cudaErrorInvalidValue;

}  // namespace

// dtype: 0 float32, 1 bfloat16 for q, k, v and o (items, F, D), F dividing
// 32, D 16 or 32, each 16-byte aligned; cos/sin (F, D/2) float32, or both
// null for no rotation. Dropout coordinates: item / heads, item % heads;
// keep iff the Philox bits < thr, kept values times scale; on == 0 turns it
// off.
extern "C" int bt_small_attn_fwd(int dtype, int F, int D, const void* q, const void* k,
                                 const void* v, const void* cosv, const void* sinv, void* o,
                                 long long items, int heads, unsigned seed, unsigned salt,
                                 unsigned thr, float scale, int on, void* stream) {
  if (items <= 0) return 0;
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(FF, DD, TT) launch_fwd<FF, DD, TT>(q, k, v, cosv, sinv, o, items, heads, d, s)
  BT_SMALL_DISPATCH(BT_CALL)
#undef BT_CALL
}

// The forward's inputs and dout (items, F, D) in the dtype; results dq, dk,
// dv (items, F, D) in the dtype.
extern "C" int bt_small_attn_bwd(int dtype, int F, int D, const void* q, const void* k,
                                 const void* v, const void* cosv, const void* sinv,
                                 const void* dout, void* dq, void* dk, void* dv, long long items,
                                 int heads, unsigned seed, unsigned salt, unsigned thr,
                                 float scale, int on, void* stream) {
  if (items <= 0) return 0;
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(FF, DD, TT) \
  launch_bwd<FF, DD, TT>(q, k, v, cosv, sinv, dout, dq, dk, dv, items, heads, d, s)
  BT_SMALL_DISPATCH(BT_CALL)
#undef BT_CALL
}
