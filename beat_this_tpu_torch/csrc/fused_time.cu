// Fused time-axis roformer block (eval):
//   y1  = x + W_out (gate * softmax(rope(q) rope(k)^T / sqrt(32)) v),
//   out = y1 + FF(y1),
// with q, k, v = W_qkv rmsnorm(x) and gate = sigmoid(W_g rmsnorm(x) + b_g)
// per head.
//
// Replaces beat_this_tpu/ops/fused_time.py:_kernel (reached through
// fused_time_roformer), which runs the whole block for one sequence in one
// program with a full 1536 x 1536 float32 score tile in VMEM. Such a tile is
// 9.4 MB, about forty times a block's shared memory, so the block is split
// into three launches with intermediates in device memory:
//
//   1. time_qkv:    per 32-row tile: RMSNorm, q/k/v projection, RoPE on q and
//                   k (interleaved pairs, half-width tables), and the per-head
//                   sigmoid gate from the float32 normed rows.
//                   Writes q, k, v as (items, heads, n, 32) and gates.
//   2. time_attn:   per (item * head, 128 queries): online-softmax (flash)
//                   attention over 64-key tiles, keys past the true length n
//                   masked, output times gate written as (items, n, C).
//   3. time_out_ff: per 32-row tile: out projection plus residual into a
//                   float32 tile, then the feed-forward residual (the
//                   device code of the fused_ff kernel).
//
// Bound on the H100: arithmetic. Attention costs 4 * n^2 * 32 FLOP per head
// and item (0.29 GFLOP at n = 1500) against O(n * 32) bytes, and the
// projections 24 C^2 FLOP per row; the intermediates (q, k, v, gates and the
// attention output, about 5 C values per row) are a few MB per call. The
// attention keeps one query row per thread with its 32-wide q and output in
// registers, and all threads of a block read the same staged key and value
// rows, so shared-memory reads are broadcasts. Products are float32 FMAs on
// the SIMT cores; bfloat16 inputs are widened on load.
#include "common.cuh"

namespace {

constexpr int kQTile = 128;  // queries per attention block (one per thread)
constexpr int kKTile = 64;   // keys per staged tile

template <int C>
__host__ __device__ constexpr int qkv_cols() { return C < 128 ? C : 128; }

template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    time_qkv_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const T* __restrict__ wqkv, const float* __restrict__ wg,
                    const float* __restrict__ gb, const float* __restrict__ cosv,
                    const float* __restrict__ sinv, T* __restrict__ q, T* __restrict__ k,
                    T* __restrict__ v, float* __restrict__ gates, int64_t rows, int n) {
  constexpr int H = C / bt::kHeadDim, ld = bt::tile_ld(C), NT = qkv_cols<C>();
  extern __shared__ float smem[];
  float* g = smem;
  float* ws = g + bt::kRows * ld;
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
  const int64_t row0 = (int64_t)blockIdx.x * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);

  bt::load_rows<C, T>(x, g, row0, nrows);
  bt::rms_rows<C, false, T>(g, g, ld, gamma);
  for (int e = tid; e < bt::kRows * H; e += bt::kThreads) {
    const int r = e / H, h = e % H;
    if (r >= nrows) continue;
    float z = 0.f;
    for (int c = 0; c < C; ++c) z += g[r * ld + c] * wg[h * C + c];
    gates[(row0 + r) * H + h] = 1.f / (1.f + expf(-(z + gb[h])));
  }
  __syncthreads();
  for (int e = tid; e < bt::kRows * C; e += bt::kThreads) {
    const int r = e / C, c = e % C;
    g[r * ld + c] = bt::round_to<T>(g[r * ld + c]);
  }
  __syncthreads();

  for (int n0 = 0; n0 < 3 * C; n0 += NT) {
    float acc[2][NT / 16];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT / 16; ++j) acc[i][j] = 0.f;
    bt::mm_acc<NT, T>(acc, g, ld, wqkv, C, n0, C, ws);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg + 16 * i;
      if (r >= nrows) continue;
      const int64_t row = row0 + r, item = row / n;
      const int t = (int)(row % n);
#pragma unroll
      for (int j = 0; j < NT / 32; ++j) {
        const int col = n0 + 2 * cp + 32 * j;  // even: one interleaved RoPE pair
        const int which = col / C, w = col % C, h = w / bt::kHeadDim, d = w % bt::kHeadDim;
        float a = acc[i][2 * j], b = acc[i][2 * j + 1];
        if (which < 2) {
          const float cs = cosv[t * (bt::kHeadDim / 2) + d / 2];
          const float sn = sinv[t * (bt::kHeadDim / 2) + d / 2];
          const float ra = a * cs - b * sn, rb = b * cs + a * sn;
          a = ra;
          b = rb;
        }
        T* dst = which == 0 ? q : which == 1 ? k : v;
        dst += ((item * H + h) * n + t) * bt::kHeadDim + d;
        dst[0] = bt::from_f<T>(a);
        dst[1] = bt::from_f<T>(b);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kQTile)
    time_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ gates, T* __restrict__ out, int n, int H,
                     float qscale) {
  __shared__ float ks[kKTile][bt::kHeadDim];
  __shared__ float vs[kKTile][bt::kHeadDim];
  const int bh = blockIdx.x, item = bh / H, h = bh % H;
  const int t = blockIdx.y * kQTile + threadIdx.x;
  const size_t base = (size_t)bh * n * bt::kHeadDim;
  float qr[bt::kHeadDim], o[bt::kHeadDim];
#pragma unroll
  for (int d = 0; d < bt::kHeadDim; ++d) {
    qr[d] = t < n ? bt::to_f(q[base + (size_t)t * bt::kHeadDim + d]) * qscale : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < n; k0 += kKTile) {
    for (int e = threadIdx.x; e < kKTile * bt::kHeadDim; e += kQTile) {
      const int r = e / bt::kHeadDim, d = e % bt::kHeadDim;
      const bool ok = k0 + r < n;
      ks[r][d] = ok ? bt::to_f(k[base + (size_t)(k0 + r) * bt::kHeadDim + d]) : 0.f;
      vs[r][d] = ok ? bt::to_f(v[base + (size_t)(k0 + r) * bt::kHeadDim + d]) : 0.f;
    }
    __syncthreads();
    const int kn = min(kKTile, n - k0);
    float s[kKTile];
    float mt = m;
#pragma unroll
    for (int j = 0; j < kKTile; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < bt::kHeadDim; ++d) acc += qr[d] * ks[j][d];
      s[j] = j < kn ? acc : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float corr = exp2f(m - mt);
    l *= corr;
#pragma unroll
    for (int d = 0; d < bt::kHeadDim; ++d) o[d] *= corr;
#pragma unroll
    for (int j = 0; j < kKTile; ++j) {
      const float p = exp2f(s[j] - mt);
      l += p;
#pragma unroll
      for (int d = 0; d < bt::kHeadDim; ++d) o[d] += p * vs[j][d];
    }
    m = mt;
    __syncthreads();
  }
  if (t >= n) return;
  const float scale = gates[((size_t)item * n + t) * H + h] / l;
  T* dst = out + ((size_t)item * n + t) * (H * bt::kHeadDim) + h * bt::kHeadDim;
#pragma unroll
  for (int d = 0; d < bt::kHeadDim; ++d) dst[d] = bt::from_f<T>(o[d] * scale);
}

template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    time_out_ff_kernel(const T* __restrict__ x, const T* __restrict__ attn,
                       const T* __restrict__ wout, const float* __restrict__ fgamma,
                       const T* __restrict__ w1, const float* __restrict__ b1,
                       const T* __restrict__ w2, const float* __restrict__ b2,
                       T* __restrict__ out, int64_t rows, int M) {
  constexpr int ld = bt::tile_ld(C), NT = qkv_cols<C>();
  extern __shared__ float smem[];
  float* y = smem;
  float* scratch = y + bt::kRows * ld;  // ff_tail's norm tile holds attn first
  float* a = scratch;
  float* ws = scratch + bt::kRows * ld + bt::kRows * (bt::kHid + 1);
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
  const int64_t row0 = (int64_t)blockIdx.x * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);

  bt::load_rows<C, T>(attn, a, row0, nrows);
  for (int n0 = 0; n0 < C; n0 += NT) {
    float acc[2][NT / 16];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT / 16; ++j) acc[i][j] = 0.f;
    bt::mm_acc<NT, T>(acc, a, ld, wout, C, n0, C, ws);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < NT / 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 2 * cp + 32 * j + e;
          const float xv = r < nrows ? bt::to_f(x[(row0 + r) * C + col]) : 0.f;
          y[r * ld + col] = xv + acc[i][2 * j + e];
        }
    }
  }
  __syncthreads();
  bt::ff_tail<C, T>(y, scratch, fgamma, w1, b1, w2, b2, M, out, row0, nrows);
}

template <int C, typename T>
cudaError_t launch(const void* x, const void* agamma, const void* wqkv, const void* wg,
                   const void* gb, const void* wout, const void* fgamma, const void* w1,
                   const void* b1, const void* w2, const void* b2, const void* cosv,
                   const void* sinv, void* q, void* k, void* v, void* gates, void* attn,
                   void* out, int items, int n, int M, cudaStream_t stream) {
  constexpr int H = C / bt::kHeadDim, ld = bt::tile_ld(C);
  const int64_t rows = (int64_t)items * n;
  const unsigned tiles = (unsigned)((rows + bt::kRows - 1) / bt::kRows);

  const size_t smem_qkv = sizeof(float) * (bt::kRows * ld + bt::stage_floats(qkv_cols<C>()));
  auto k1 = time_qkv_kernel<C, T>;
  cudaError_t err = bt::allow_smem(k1, smem_qkv);
  if (err != cudaSuccess) return err;
  k1<<<tiles, bt::kThreads, smem_qkv, stream>>>(
      (const T*)x, (const float*)agamma, (const T*)wqkv, (const float*)wg, (const float*)gb,
      (const float*)cosv, (const float*)sinv, (T*)q, (T*)k, (T*)v, (float*)gates, rows, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 grid(items * H, (n + kQTile - 1) / kQTile);
  const float qscale = 0.17677669529663688f * 1.4426950408889634f;  // 32^-0.5 * log2(e)
  time_attn_kernel<T><<<grid, kQTile, 0, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                   (const float*)gates, (T*)attn, n, H, qscale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_ff = sizeof(float) * (bt::kRows * ld + bt::ff_tail_floats<C>());
  auto k3 = time_out_ff_kernel<C, T>;
  if ((err = bt::allow_smem(k3, smem_ff)) != cudaSuccess) return err;
  k3<<<tiles, bt::kThreads, smem_ff, stream>>>(
      (const T*)x, (const T*)attn, (const T*)wout, (const float*)fgamma, (const T*)w1,
      (const float*)b1, (const T*)w2, (const float*)b2, (T*)out, rows, M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int C, const void* x, const void* agamma, const void* wqkv, const void* wg,
                     const void* gb, const void* wout, const void* fgamma, const void* w1,
                     const void* b1, const void* w2, const void* b2, const void* cosv,
                     const void* sinv, void* q, void* k, void* v, void* gates, void* attn,
                     void* out, int items, int n, int M, cudaStream_t s) {
#define BT_TIME_CASE(CC)                                                                      \
  case CC:                                                                                    \
    return launch<CC, T>(x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv, sinv, q, \
                         k, v, gates, attn, out, items, n, M, s);
  switch (C) {
    BT_TIME_CASE(32)
    BT_TIME_CASE(64)
    BT_TIME_CASE(128)
    BT_TIME_CASE(512)
    default: return cudaErrorInvalidValue;
  }
#undef BT_TIME_CASE
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 for x, wqkv (3C, C), wout (C, C), w1 (M, C),
// w2 (C, M), out and the scratch q, k, v (items, C/32, n, 32) and attn
// (items, n, C); agamma, wg (C/32, C), gb, fgamma, b1, b2, cos/sin (n, 16)
// and gates (items * n, C/32) are float32. x and out are (items, n, C).
extern "C" int bt_fused_time(int dtype, int C, const void* x, const void* agamma,
                             const void* wqkv, const void* wg, const void* gb, const void* wout,
                             const void* fgamma, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* cosv, const void* sinv, void* q,
                             void* k, void* v, void* gates, void* attn, void* out, int items,
                             int n, int M, void* stream) {
  if (items <= 0 || n <= 0) return 0;
  if (M % bt::kHid) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0 ? dispatch<float>(C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2,
                                   cosv, sinv, q, k, v, gates, attn, out, items, n, M, s)
      : dtype == 1
          ? dispatch<__nv_bfloat16>(C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2,
                                    cosv, sinv, q, k, v, gates, attn, out, items, n, M, s)
          : cudaErrorInvalidValue;
  return (int)err;
}
