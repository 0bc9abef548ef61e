// Shared device code of the CUDA kernels: the element conversions and
// roundings between float32 and bf16, GELU and its derivative, the
// shared-memory limit, and the 32-row float32 tile of 256 threads that B5's
// row epilogue (fused_time_train.cu) loads with `load_rows` (row stride
// tile_ld(C) = C + 1 floats, so that the two row groups of a warp hit
// different banks). The products of every kernel run on the tensor cores
// (mma.cuh, tc_product.cuh, attn_tc.cuh), not here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace bt {

constexpr int kThreads = 256;
constexpr int kRows = 32;     // activation rows per row-tile block
constexpr int kHeadDim = 32;  // the model's only head size

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T's precision, returned as float
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// d/dv of gelu_exact
__device__ __forceinline__ float gelu_grad(float v) {
  const float phi = expf(-0.5f * v * v) * 0.39894228040143268f;
  return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) + v * phi;
}

__host__ __device__ constexpr int tile_ld(int c) { return c + 1; }

// Rows of the tile starting at row0 that lie inside a tensor of `rows` rows.
__device__ __forceinline__ int tile_rows(int64_t rows, int64_t row0) {
  const int64_t left = rows - row0;
  return left < kRows ? (int)left : kRows;
}

// Load rows [row0, row0 + nrows) of a (rows, C) tensor into a float tile,
// zero-filling the rows past the end. Ends with a barrier.
template <int C, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, float* dst, int64_t row0,
                                          int nrows) {
  for (int e = threadIdx.x; e < kRows * C; e += kThreads) {
    const int r = e / C, c = e % C;
    dst[r * tile_ld(C) + c] = r < nrows ? to_f(src[(row0 + r) * C + c]) : 0.f;
  }
  __syncthreads();
}

// Raise the dynamic shared-memory limit of `kernel` when it needs more than
// the default 48 KB; returns the first error.
template <typename K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace bt
