// Feed-forward residual for training, forward and backward:
//   out = x + drop_out(W2 drop_hid(gelu(W1 g + b1)) + b2),  g = rmsnorm(x) * gamma,
// with the dropout masks drawn from Philox (philox.cuh) by element
// coordinates, so the backward regenerates the forward's masks.
//
// Replaces beat_this_tpu/ops/fused_ff.py:_ff_train_kernel (forward, reached
// through _fused_ff_train) and :_ff_train_bwd_kernel (backward, through
// _fused_ff_train_bwd). On the TPU the backward accumulates the weight
// gradients across its sequential grid; here blocks run in parallel, so the
// backward is three launches and no float atomics:
//
//   1. ff_bwd_rows:  per 32-row tile, recompute the forward hidden layer
//                    64 units at a time, pull d_y back through W2, the hidden
//                    mask and the GELU, and accumulate d_g = d_pre1 W1 in
//                    registers; then dx = dout + rmsnorm'(d_g), and per-tile
//                    partials of dgamma and db2.
//   2. ff_wgrad:     per (32 hidden units, group of row tiles), recompute
//                    pre1, h1 and d_pre1 for those units and accumulate
//                    dW1 = d_pre1^T g and dW2 = d_y^T h1 over the group's rows
//                    in registers, and db1; one partial per group.
//   3. sum_partials: sum the per-tile and per-group partials in a fixed
//                    order, so two runs give the same bits.
//
// The (rows, 4C) hidden activations never reach device memory, in either
// pass; the price is recomputing the forward products (the backward does
// about 3.5x the forward's multiply-adds).
//
// Bound on the H100: arithmetic. At C = 512, M = 2048 every row costs 2 C M
// multiply-adds in the forward and about 7 C M in the backward, against
// 4 C activation values read or written. Products are float32 FMAs on the
// SIMT cores, as in fused_ff.cu; bfloat16 values are widened on load and
// rounded where the TPU kernel rounds (g, the dropped hidden layer, d_y and
// d_pre1 before their products).
#include "common.cuh"

namespace bt {
namespace {

__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int parts,
                        int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[p * n + i];
  out[i] = s;
}

}  // namespace

cudaError_t sum_partials(const float* part, float* out, int parts, int64_t n,
                         cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  sum_partials_kernel<<<blocks, kThreads, 0, stream>>>(part, out, parts, n);
  return cudaGetLastError();
}

}  // namespace bt

namespace {

constexpr int kWChunk = 32;  // hidden units per weight-gradient block

template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    ff_train_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                        const T* __restrict__ w1, const float* __restrict__ b1,
                        const T* __restrict__ w2, const float* __restrict__ b2,
                        T* __restrict__ out, int64_t rows, int M, bt::Dropout drop) {
  extern __shared__ float smem[];
  float* y = smem;
  const int64_t row0 = (int64_t)blockIdx.x * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);
  bt::load_rows<C, T>(x, y, row0, nrows);
  bt::ff_tail<C, T>(y, y + bt::kRows * bt::tile_ld(C), gamma, w1, b1, w2, b2, M, out, row0,
                    nrows, drop);
}

template <int C>
__host__ __device__ constexpr int rows_smem_floats() {
  return 2 * bt::kRows * bt::tile_ld(C) + bt::kRows * (bt::kHid + 1) +
         bt::stage_floats(C > bt::kHid ? C : bt::kHid) + bt::kRows;
}

template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    ff_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const T* __restrict__ w1, const float* __restrict__ b1,
                       const T* __restrict__ w2, const T* __restrict__ dout,
                       T* __restrict__ dx, float* __restrict__ db2p, float* __restrict__ dgp,
                       int64_t rows, int M, bt::Dropout drop) {
  constexpr int ld = bt::tile_ld(C), hld = bt::kHid + 1;
  extern __shared__ float smem[];
  float* gt = smem;                // round_T(g), later dgamma's products
  float* dy = gt + bt::kRows * ld;  // round_T(dout * output mask)
  float* h = dy + bt::kRows * ld;   // one chunk of round_T(d_pre1)
  float* ws = h + bt::kRows * hld;
  float* rn = ws + bt::stage_floats(C > bt::kHid ? C : bt::kHid);  // row norms
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t row0 = (int64_t)blockIdx.x * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);
  const float sc = sqrtf((float)C);

  bt::load_rows<C, T>(x, gt, row0, nrows);
  for (int r = warp; r < bt::kRows; r += bt::kThreads / 32) {
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) ss += gt[r * ld + c] * gt[r * ld + c];
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    if (lane == 0) rn[r] = nrm;
    for (int c = lane; c < C; c += 32)
      gt[r * ld + c] = bt::round_to<T>(gt[r * ld + c] / nrm * sc * gamma[c]);
  }
  bt::load_dy<C, T>(dout, dy, row0, nrows, drop, db2p + blockIdx.x * (int64_t)C);

  float acc[2][C / 16];
  bt::zero(acc);
  for (int j0 = 0; j0 < M; j0 += bt::kHid) {
    float hacc[2][bt::kHid / 16], dacc[2][bt::kHid / 16];
    bt::zero(hacc);
    bt::zero(dacc);
    bt::mm_acc<bt::kHid, T>(hacc, gt, ld, w1, C, j0, C, ws);
    bt::mm_acc_t<bt::kHid, T>(dacc, dy, ld, w2, M, j0, C, ws);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < bt::kHid / 32; ++j) {
        const int r = rg + 16 * i, c0 = j0 + 2 * cp + 32 * j;
        float f[4];
        bt::keep4(drop, bt::kSiteFFHidden, 0, 0, (uint32_t)(row0 + r), c0 >> 2, f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pre = hacc[i][2 * j + e] + b1[c0 + e];
          const float d = dacc[i][2 * j + e] * f[(c0 & 3) + e] * bt::gelu_grad(pre);
          h[r * hld + c0 - j0 + e] = bt::round_to<T>(d);
        }
      }
    __syncthreads();
    bt::mm_acc_t<C, T>(acc, h, hld, w1 + (size_t)j0 * C, C, 0, bt::kHid, ws);
  }

  // acc holds d_g. dx = dout + (w - n (n . w)) / r with w = d_g gamma sqrt(C)
  // and n = x / r; rows rg and rg + 16 are spread over the 16 threads of a
  // half warp.
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg + 16 * i;
#pragma unroll
    for (int j = 0; j < C / 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * cp + 32 * j + e;
        const float n = r < nrows ? bt::to_f(x[(row0 + r) * C + col]) / rn[r] : 0.f;
        s[i] += n * acc[i][2 * j + e] * gamma[col] * sc;
        gt[r * ld + col] = acc[i][2 * j + e] * n * sc;
      }
#pragma unroll
    for (int o = 8; o; o >>= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg + 16 * i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < C / 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * cp + 32 * j + e;
        const int64_t at = (row0 + r) * C + col;
        const float n = bt::to_f(x[at]) / rn[r];
        const float w = acc[i][2 * j + e] * gamma[col] * sc;
        dx[at] = bt::from_f<T>(bt::to_f(dout[at]) + (w - n * s[i]) / rn[r]);
      }
  }
  __syncthreads();
  for (int c = tid; c < C; c += bt::kThreads) {
    float sum = 0.f;
    for (int r = 0; r < bt::kRows; ++r) sum += gt[r * ld + c];
    dgp[blockIdx.x * (int64_t)C + c] = sum;
  }
}

template <int C>
__host__ __device__ constexpr int wgrad_smem_floats() {
  return 2 * bt::kRows * bt::tile_ld(C) + 3 * bt::kRows * (kWChunk + 1) +
         bt::stage_floats(kWChunk);
}

template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    ff_wgrad_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const T* __restrict__ w1, const float* __restrict__ b1,
                    const T* __restrict__ w2, const T* __restrict__ dout,
                    float* __restrict__ dw1p, float* __restrict__ dw2p,
                    float* __restrict__ db1p, int64_t rows, int M, int tiles_per_group,
                    bt::Dropout drop) {
  constexpr int ld = bt::tile_ld(C), cl = kWChunk + 1, NI = C / 32;
  extern __shared__ float smem[];
  float* gt = smem;
  float* dy = gt + bt::kRows * ld;
  float* dp = dy + bt::kRows * ld;  // round_T(d_pre1) for this chunk
  float* dpf = dp + bt::kRows * cl;  // d_pre1 in float32 (db1)
  float* hd = dpf + bt::kRows * cl;  // round_T(dropped h1)
  float* ws = hd + bt::kRows * cl;
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
  const int j0 = blockIdx.x * kWChunk, g = blockIdx.y;
  const int64_t tiles = (rows + bt::kRows - 1) / bt::kRows;
  const int64_t t_end = min((int64_t)(g + 1) * tiles_per_group, tiles);

  float acc1[4][NI], acc2[4][NI];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < NI; ++i) acc1[a][i] = acc2[a][i] = 0.f;
  float db1 = 0.f;

  for (int64_t t = (int64_t)g * tiles_per_group; t < t_end; ++t) {
    const int64_t row0 = t * bt::kRows;
    const int nrows = bt::tile_rows(rows, row0);
    bt::load_rows<C, T>(x, gt, row0, nrows);
    bt::rms_rows<C, true, T>(gt, gt, ld, gamma);
    bt::load_dy<C, T>(dout, dy, row0, nrows, drop, nullptr);
    float hacc[2][kWChunk / 16], dacc[2][kWChunk / 16];
    bt::zero(hacc);
    bt::zero(dacc);
    bt::mm_acc<kWChunk, T>(hacc, gt, ld, w1, C, j0, C, ws);
    bt::mm_acc_t<kWChunk, T>(dacc, dy, ld, w2, M, j0, C, ws);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg + 16 * i, c0 = j0 + 2 * cp;
      float f[4];
      bt::keep4(drop, bt::kSiteFFHidden, 0, 0, (uint32_t)(row0 + r), c0 >> 2, f);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = r < nrows;
        const float pre = hacc[i][e] + b1[c0 + e], fe = f[(c0 & 3) + e];
        const float d = ok ? dacc[i][e] * fe * bt::gelu_grad(pre) : 0.f;
        hd[r * cl + 2 * cp + e] = ok ? bt::round_to<T>(bt::gelu_exact(pre) * fe) : 0.f;
        dpf[r * cl + 2 * cp + e] = d;
        dp[r * cl + 2 * cp + e] = bt::round_to<T>(d);
      }
    }
    __syncthreads();
    bt::outer_acc<NI>(acc1, dp, cl, gt, ld);  // dW1[j][c] += d_pre1[r][j] g[r][c]
    bt::outer_acc<NI>(acc2, hd, cl, dy, ld);  // dW2[c][j] += d_y[r][c] h1[r][j]
    if (tid < kWChunk)
      for (int r = 0; r < bt::kRows; ++r) db1 += dpf[r * cl + tid];
    __syncthreads();
  }

  const int lane = tid & 31, l0 = 4 * (tid >> 5);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int j = j0 + l0 + a, c = lane + 32 * i;
      dw1p[(size_t)g * M * C + (size_t)j * C + c] = acc1[a][i];
      dw2p[(size_t)g * C * M + (size_t)c * M + j] = acc2[a][i];
    }
  if (tid < kWChunk) db1p[(size_t)g * M + j0 + tid] = db1;
}

template <int C, typename T>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int64_t rows, int M,
                       bt::Dropout drop, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (bt::kRows * bt::tile_ld(C) + bt::ff_tail_floats<C>());
  auto kernel = ff_train_fwd_kernel<C, T>;
  cudaError_t err = bt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((rows + bt::kRows - 1) / bt::kRows);
  kernel<<<blocks, bt::kThreads, smem, stream>>>(
      (const T*)x, (const float*)gamma, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (T*)out, rows, M, drop);
  return cudaGetLastError();
}

template <int C, typename T>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* w1, const void* b1,
                       const void* w2, const void* dout, void* dx, void* dgamma, void* dw1,
                       void* db1, void* dw2, void* db2, void* scratch, int64_t rows, int M,
                       int groups, bt::Dropout drop, cudaStream_t stream) {
  const int64_t tiles = (rows + bt::kRows - 1) / bt::kRows;
  float* db2p = (float*)scratch;
  float* dgp = db2p + tiles * C;
  float* dw1p = dgp + tiles * C;
  float* dw2p = dw1p + (int64_t)groups * M * C;
  float* db1p = dw2p + (int64_t)groups * M * C;

  const size_t smem1 = sizeof(float) * rows_smem_floats<C>();
  auto k1 = ff_bwd_rows_kernel<C, T>;
  cudaError_t err = bt::allow_smem(k1, smem1);
  if (err != cudaSuccess) return err;
  k1<<<(unsigned)tiles, bt::kThreads, smem1, stream>>>(
      (const T*)x, (const float*)gamma, (const T*)w1, (const float*)b1, (const T*)w2,
      (const T*)dout, (T*)dx, db2p, dgp, rows, M, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem2 = sizeof(float) * wgrad_smem_floats<C>();
  auto k2 = ff_wgrad_kernel<C, T>;
  if ((err = bt::allow_smem(k2, smem2)) != cudaSuccess) return err;
  const int tpg = (int)((tiles + groups - 1) / groups);
  k2<<<dim3(M / kWChunk, groups), bt::kThreads, smem2, stream>>>(
      (const T*)x, (const float*)gamma, (const T*)w1, (const float*)b1, (const T*)w2,
      (const T*)dout, dw1p, dw2p, db1p, rows, M, tpg, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = bt::sum_partials(db2p, (float*)db2, (int)tiles, C, stream)) != cudaSuccess) return err;
  if ((err = bt::sum_partials(dgp, (float*)dgamma, (int)tiles, C, stream)) != cudaSuccess)
    return err;
  if ((err = bt::sum_partials(dw1p, (float*)dw1, groups, (int64_t)M * C, stream)) != cudaSuccess)
    return err;
  if ((err = bt::sum_partials(dw2p, (float*)dw2, groups, (int64_t)M * C, stream)) != cudaSuccess)
    return err;
  return bt::sum_partials(db1p, (float*)db1, groups, M, stream);
}

#define BT_FF_SWITCH(CALL)                          \
  switch (C) {                                      \
    case 32: return CALL(32);                       \
    case 64: return CALL(64);                       \
    case 128: return CALL(128);                     \
    case 256: return CALL(256);                     \
    case 384: return CALL(384);                     \
    case 512: return CALL(512);                     \
    default: return cudaErrorInvalidValue;          \
  }

template <typename T>
cudaError_t dispatch_fwd(int C, const void* x, const void* gamma, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out, int64_t rows, int M,
                         bt::Dropout drop, cudaStream_t s) {
#define BT_CALL(CC) launch_fwd<CC, T>(x, gamma, w1, b1, w2, b2, out, rows, M, drop, s)
  BT_FF_SWITCH(BT_CALL)
#undef BT_CALL
}

template <typename T>
cudaError_t dispatch_bwd(int C, const void* x, const void* gamma, const void* w1, const void* b1,
                         const void* w2, const void* dout, void* dx, void* dgamma, void* dw1,
                         void* db1, void* dw2, void* db2, void* scratch, int64_t rows, int M,
                         int groups, bt::Dropout drop, cudaStream_t s) {
#define BT_CALL(CC)                                                                         \
  launch_bwd<CC, T>(x, gamma, w1, b1, w2, dout, dx, dgamma, dw1, db1, dw2, db2, scratch, rows, \
                    M, groups, drop, s)
  BT_FF_SWITCH(BT_CALL)
#undef BT_CALL
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w1, w2, out); gamma, b1, b2 float32.
// x, out (rows, C); w1 (M, C); w2 (C, M); M % 64 == 0. Dropout: keep iff the
// Philox bits < thr, kept values times scale; on == 0 turns it off.
extern "C" int bt_ff_train_fwd(int dtype, int C, const void* x, const void* gamma,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* out, long long rows, int M, unsigned seed, unsigned salt,
                               unsigned thr, float scale, int on, void* stream) {
  if (rows <= 0) return 0;
  if (M % bt::kHid) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? dispatch_fwd<float>(C, x, gamma, w1, b1, w2, b2, out, rows, M, d, s)
               : dtype == 1
                   ? dispatch_fwd<__nv_bfloat16>(C, x, gamma, w1, b1, w2, b2, out, rows, M, d, s)
                   : cudaErrorInvalidValue);
}

// As bt_ff_train_fwd, plus dout and dx (rows, C) in the dtype and float32
// gradients dgamma (C), dw1 (M, C), db1 (M), dw2 (C, M), db2 (C). scratch:
// 2 * ceil(rows / 32) * C + groups * (2 * M * C + M) floats;
// 1 <= groups <= ceil(rows / 32) row-tile groups for the weight gradients.
extern "C" int bt_ff_train_bwd(int dtype, int C, const void* x, const void* gamma,
                               const void* w1, const void* b1, const void* w2, const void* dout,
                               void* dx, void* dgamma, void* dw1, void* db1, void* dw2, void* db2,
                               void* scratch, long long rows, int M, int groups, unsigned seed,
                               unsigned salt, unsigned thr, float scale, int on, void* stream) {
  if (rows <= 0) return 0;
  if (M % bt::kHid || groups < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? dispatch_bwd<float>(C, x, gamma, w1, b1, w2, dout, dx, dgamma, dw1, db1, dw2,
                                         db2, scratch, rows, M, groups, d, s)
               : dtype == 1
                   ? dispatch_bwd<__nv_bfloat16>(C, x, gamma, w1, b1, w2, dout, dx, dgamma, dw1,
                                                 db1, dw2, db2, scratch, rows, M, groups, d, s)
                   : cudaErrorInvalidValue);
}
