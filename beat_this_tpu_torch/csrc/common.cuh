// Shared device code for the row-tile kernels of beat_this_tpu_torch.
//
// Every row-tile kernel runs 256 threads over a tile of kRows = 32 activation
// rows held in shared memory as float32. Matrix products against a weight in
// torch Linear layout (out_features, in_features) go through `mm_acc`: the
// weight is streamed through shared memory in chunks of kKC input features,
// and each thread accumulates a 2-row x (NCOL / 16)-column patch in float32
// registers (rows rg and rg + 16, columns 2*cp + 32*j + {0, 1}, with
// cp = tid % 16 and rg = tid / 16). Activation tiles use a row stride of C + 1
// floats so that the two row groups of a warp hit different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bt {

constexpr int kThreads = 256;
constexpr int kRows = 32;     // activation rows per row-tile block
constexpr int kKC = 16;       // input features per staged weight chunk
constexpr int kHid = 64;      // hidden units per feed-forward chunk
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

__host__ __device__ constexpr int tile_ld(int c) { return c + 1; }

// Floats of the weight staging buffer `mm_acc` needs for NCOL columns.
__host__ __device__ constexpr int stage_floats(int ncol) { return ncol * (kKC + 1); }

// acc[i][2j+e] += sum_k A[(rg + 16 i) * lda + k] * W[(n0 + 2cp + 32j + e) * ldw + k]
// for k in [0, K). A: kRows x K float tile in shared memory. W: global, torch
// Linear layout (row n holds the K inputs of output n). K % kKC == 0,
// NCOL % 32 == 0. Ws: stage_floats(NCOL) floats of shared memory.
template <int NCOL, typename T>
__device__ __forceinline__ void mm_acc(float (&acc)[2][NCOL / 16], const float* A, int lda,
                                       const T* __restrict__ W, int ldw, int n0, int K,
                                       float* Ws) {
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    for (int e = tid; e < NCOL * kKC; e += kThreads) {
      const int n = e / kKC, k = e % kKC;
      Ws[n * (kKC + 1) + k] = to_f(W[(size_t)(n0 + n) * ldw + k0 + k]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKC; ++k) {
      const float a0 = A[rg * lda + k0 + k];
      const float a1 = A[(rg + 16) * lda + k0 + k];
#pragma unroll
      for (int j = 0; j < NCOL / 32; ++j) {
        const float w0 = Ws[(2 * cp + 32 * j) * (kKC + 1) + k];
        const float w1 = Ws[(2 * cp + 1 + 32 * j) * (kKC + 1) + k];
        acc[0][2 * j] += a0 * w0;
        acc[0][2 * j + 1] += a0 * w1;
        acc[1][2 * j] += a1 * w0;
        acc[1][2 * j + 1] += a1 * w1;
      }
    }
    __syncthreads();
  }
}

// dst = rmsnorm(src) * gamma row by row (F.normalize(x) * sqrt(C) * gamma,
// norm clamped at 1e-12), optionally rounded to T. src may equal dst. Ends
// with a barrier.
template <int C, bool ROUND, typename T>
__device__ __forceinline__ void rms_rows(const float* src, float* dst, int ld,
                                         const float* __restrict__ gamma) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float sc = sqrtf((float)C);
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = src[r * ld + c];
      ss += v * v;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    for (int c = lane; c < C; c += 32) {
      const float g = src[r * ld + c] / nrm * sc * gamma[c];
      dst[r * ld + c] = ROUND ? round_to<T>(g) : g;
    }
  }
  __syncthreads();
}

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

// Shared-memory floats `ff_tail` needs beyond the y tile: the norm tile, the
// hidden chunk and the weight staging buffer.
template <int C> __host__ __device__ constexpr int ff_tail_floats() {
  return kRows * tile_ld(C) + kRows * (kHid + 1) + stage_floats(C > kHid ? C : kHid);
}

// The feed-forward residual over a row tile:
//   out = y + W2 gelu(W1 round_T(rmsnorm(y) * gamma) + b1) + b2,
// with the hidden layer streamed kHid units at a time so it never leaves the
// block. y: kRows x C float tile (stride tile_ld(C)), unchanged. scratch:
// ff_tail_floats<C>() floats. Weights in torch layout: w1 (M, C), w2 (C, M).
template <int C, typename T>
__device__ __forceinline__ void ff_tail(const float* y, float* scratch,
                                        const float* __restrict__ gamma,
                                        const T* __restrict__ w1, const float* __restrict__ b1,
                                        const T* __restrict__ w2, const float* __restrict__ b2,
                                        int M, T* __restrict__ out, int64_t row0, int nrows) {
  constexpr int ld = tile_ld(C);
  float* g = scratch;
  float* h = g + kRows * ld;
  float* ws = h + kRows * (kHid + 1);
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;

  rms_rows<C, true, T>(y, g, ld, gamma);
  float acc[2][C / 16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < C / 16; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < M; j0 += kHid) {
    float hacc[2][kHid / 16];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kHid / 16; ++j) hacc[i][j] = 0.f;
    mm_acc<kHid, T>(hacc, g, ld, w1, C, j0, C, ws);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kHid / 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * cp + 32 * j + e;
          h[(rg + 16 * i) * (kHid + 1) + col] =
              round_to<T>(gelu_exact(hacc[i][2 * j + e] + b1[j0 + col]));
        }
    __syncthreads();
    mm_acc<C, T>(acc, h, kHid + 1, w2 + j0, M, 0, kHid, ws);
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
        out[(row0 + r) * C + col] = from_f<T>(y[r * ld + col] + acc[i][2 * j + e] + b2[col]);
      }
  }
}

// Raise the dynamic shared-memory limit of `kernel` when it needs more than
// the default 48 KB; returns the first error.
template <typename K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace bt
