// Fused feed-forward residual: out = x + W2 gelu(W1 rmsnorm(x) + b1) + b2.
//
// Replaces beat_this_tpu/ops/fused_ff.py:_ff_kernel (reached through
// fused_ff), the eval feed-forward residual that the short-piece path runs
// in every time block and main layer.
//
// Bound on the H100: arithmetic. Each row costs 4 * C * M multiply-adds
// (M = 4 C) against 2 * C activation values read and written, so at C = 512
// a 32-row tile does ~134 MFLOP for 64 KB of activations; the weights (4 MB
// f32 at C = 512) are re-read from L2 by every tile.
//
// Design: one 256-thread block per 32-row tile; the tile, its norm and one
// 64-unit chunk of the hidden layer live in shared memory (at C = 512 the
// whole 32 x 2048 hidden layer would be 256 KB, more than a block may hold),
// so the hidden width is streamed: gelu(g W1[:, j:j+64] + b1) for one chunk,
// then that chunk times W2[j:j+64, :] is added to float32 register
// accumulators. Weights stream through shared memory 16 input features at a
// time. Products are float32 FMAs on the SIMT cores; bfloat16 inputs are
// widened on load. The ragged last tile is masked in the kernel.
#include "common.cuh"

namespace {

template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    fused_ff_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const T* __restrict__ w1, const float* __restrict__ b1,
                    const T* __restrict__ w2, const float* __restrict__ b2,
                    T* __restrict__ out, int64_t rows, int M) {
  extern __shared__ float smem[];
  float* y = smem;
  const int64_t row0 = (int64_t)blockIdx.x * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);
  bt::load_rows<C, T>(x, y, row0, nrows);
  bt::ff_tail<C, T>(y, y + bt::kRows * bt::tile_ld(C), gamma, w1, b1, w2, b2, M, out, row0,
                    nrows);
}

template <int C, typename T>
cudaError_t launch(const void* x, const void* gamma, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int64_t rows, int M,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (bt::kRows * bt::tile_ld(C) + bt::ff_tail_floats<C>());
  auto kernel = fused_ff_kernel<C, T>;
  cudaError_t err = bt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((rows + bt::kRows - 1) / bt::kRows);
  kernel<<<blocks, bt::kThreads, smem, stream>>>(
      (const T*)x, (const float*)gamma, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (T*)out, rows, M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int C, const void* x, const void* gamma, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* out, int64_t rows, int M,
                     cudaStream_t s) {
  switch (C) {
    case 32: return launch<32, T>(x, gamma, w1, b1, w2, b2, out, rows, M, s);
    case 64: return launch<64, T>(x, gamma, w1, b1, w2, b2, out, rows, M, s);
    case 128: return launch<128, T>(x, gamma, w1, b1, w2, b2, out, rows, M, s);
    case 512: return launch<512, T>(x, gamma, w1, b1, w2, b2, out, rows, M, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* bt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 float32, 1 bfloat16 (x, w1, w2, out); gamma, b1, b2 float32.
// x, out (rows, C); w1 (M, C); w2 (C, M). M % 64 == 0.
extern "C" int bt_fused_ff(int dtype, int C, const void* x, const void* gamma, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out,
                           long long rows, int M, void* stream) {
  if (rows <= 0) return 0;
  if (M % bt::kHid) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0 ? dispatch<float>(C, x, gamma, w1, b1, w2, b2, out, rows, M, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(C, x, gamma, w1, b1, w2, b2, out, rows, M, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
