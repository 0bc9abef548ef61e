// The first launch of the time-axis roformer blocks, shared by the eval
// kernel (fused_time.cu) and the training forward (fused_time_train.cu):
// per 32-row tile, RMSNorm, the q/k/v projection, RoPE on q and k
// (interleaved pairs, half-width tables) and the per-head sigmoid gate from
// the float32 normed rows. Writes q, k, v as (items, heads, n, 32), rounded
// to T after RoPE, and the float32 gates as (items * n, heads).
#pragma once

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

}  // namespace
