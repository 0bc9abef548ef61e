// The attention half of the SIMT frequency-axis block over one 32-row tile:
//   y1 = x + W_out (gate * softmax(rope(q) rope(k)^T / sqrt(32)) v),
// with attention within each item of F consecutive rows. The design of the
// eval block before it moved onto the tensor cores (fused_freq.cu), kept for
// the stage-by-stage ablation kernels (freq_ablate.cu), which cut it.
//
// One thread per (row, head) walks the item's F keys with an online softmax.
#pragma once

#include "common.cuh"

namespace bt {

// Dynamic shared memory of the ablation kernels (freq_ablate.cu): the x / y1
// tile, ff_tail's scratch, the q/k/v tile and the gates.
template <int C> __host__ __device__ constexpr size_t freq_smem_bytes() {
  return sizeof(float) * (kRows * tile_ld(C) + ff_tail_floats<C>() + kRows * (3 * C + 1) +
                          kRows * (C / kHeadDim));
}

// On entry, behind a barrier: y holds the tile's x (kRows x tile_ld(C)
// floats) and g its normed rows round_T(rmsnorm(x) * agamma). On exit,
// behind a barrier: y holds y1, g the gated attention output
// round_T(round_T(o) * gate), qkv (kRows x (3C + 1)) the rounded q and k
// after RoPE and v, gate (kRows x C/32) the rounded gates. ws:
// stage_floats(C) floats. Tiles start on item boundaries.
template <int C, typename T>
__device__ __forceinline__ void freq_attention(
    float* y, float* g, float* qkv, float* gate, float* ws, const T* __restrict__ wqkv,
    const float* __restrict__ wg, const float* __restrict__ gb, const T* __restrict__ wout,
    const float* __restrict__ cosv, const float* __restrict__ sinv, int F, float qscale) {
  constexpr int H = C / kHeadDim, ld = tile_ld(C), ldq = 3 * C + 1;
  constexpr int NT = C;  // q/k/v column tile: one third of the projection
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;

  for (int e = tid; e < kRows * H; e += kThreads) {
    const int r = e / H, h = e % H;
    float z = 0.f;
    for (int c = 0; c < C; ++c) z += g[r * ld + c] * wg[h * C + c];
    const float s = 1.f / (1.f + expf(-(z + gb[h])));
    gate[r * H + h] = round_to<T>(s);
  }
  // q, k, v rounded to T (the TPU kernel's qkv is in the compute dtype), then
  // RoPE on q and k at position r % F (tiles start on item boundaries)
  for (int n0 = 0; n0 < 3 * C; n0 += NT) {
    float acc[2][NT / 16];
    zero(acc);
    mm_acc<NT, T>(acc, g, ld, wqkv, C, n0, C, ws);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg + 16 * i, pos = r % F;
#pragma unroll
      for (int j = 0; j < NT / 32; ++j) {
        const int col = n0 + 2 * cp + 32 * j, d = col % kHeadDim;
        float a = round_to<T>(acc[i][2 * j]), b = round_to<T>(acc[i][2 * j + 1]);
        if (col < 2 * C) {
          const float cs = cosv[pos * (kHeadDim / 2) + d / 2];
          const float sn = sinv[pos * (kHeadDim / 2) + d / 2];
          const float ra = round_to<T>(a * cs - b * sn);
          const float rb = round_to<T>(b * cs + a * sn);
          a = ra;
          b = rb;
        }
        qkv[r * ldq + col] = a;
        qkv[r * ldq + col + 1] = b;
      }
    }
  }
  __syncthreads();  // also orders the gate writes before their reads below

  // attention within each item: one thread per (row, head)
  for (int e = tid; e < kRows * H; e += kThreads) {
    const int r = e / H, h = e % H, first = r - r % F;
    const float* qr = qkv + r * ldq + h * kHeadDim;
    float qv[kHeadDim], o[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) {
      qv[d] = qr[d] * qscale;
      o[d] = 0.f;
    }
    float m = -INFINITY, l = 0.f;
    for (int j = first; j < first + F; ++j) {
      const float* kr = qkv + j * ldq + C + h * kHeadDim;
      const float* vr = kr + C;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) s += qv[d] * kr[d];
      const float mn = fmaxf(m, s), corr = exp2f(m - mn), p = exp2f(s - mn);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) o[d] = o[d] * corr + p * vr[d];
      m = mn;
    }
    // g is free once q/k/v and the gates are computed
    const float gt = gate[r * H + h];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) {
      g[r * ld + h * kHeadDim + d] = round_to<T>(round_to<T>(o[d] / l) * gt);
    }
  }
  __syncthreads();

  // y1 = x + W_out o, in place over x (each element is read and written by
  // the thread that owns it)
  for (int n0 = 0; n0 < C; n0 += NT) {
    float acc[2][NT / 16];
    zero(acc);
    mm_acc<NT, T>(acc, g, ld, wout, C, n0, C, ws);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < NT / 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) y[r * ld + n0 + 2 * cp + 32 * j + e] += acc[i][2 * j + e];
    }
  }
  __syncthreads();
}

}  // namespace bt
