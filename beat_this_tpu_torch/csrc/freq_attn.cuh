// The attention half of the fused frequency-axis block over one 32-row tile:
//   y1 = x + drop_out(W_out (gate * softmax(rope(q) rope(k)^T / sqrt(32)) v)),
// with attention within each item of F consecutive rows. Shared by the eval
// and training forward kernels (fused_freq.cu) and by the ablation kernels
// (freq_ablate.cu).
//
// One thread per (row, head) walks the item's F keys. At eval (TRAIN false)
// it keeps an online softmax, as the eval kernel always has. In training it
// follows beat_this_tpu/ops/fused_freq.py:_attention: a first pass over the
// keys finds the row's largest score, the second forms the unnormalized
// probabilities p, sums them undropped into the denominator l, and
// multiplies v by round_T(p * keep) (torch's dropout of the normalized
// probabilities, the mask applied before the PV product). The keep factors
// of a tile's probabilities are drawn once into shared memory (`pmask`), so
// each Philox call serves four keys.
#pragma once

#include "common.cuh"

namespace bt {

// Floats of a tile's probability keep factors: (row, head, key), F <= 32.
template <int C> __host__ __device__ constexpr int pmask_floats() {
  return kRows * (C / kHeadDim) * 32;
}

// Dynamic shared memory of the fused forward kernel (fused_freq.cu) and of
// its stage-by-stage ablations (freq_ablate.cu), which keep its layout: the
// x / y1 tile, ff_tail's scratch, the q/k/v tile, the gates and, in
// training, the probabilities' keep factors.
template <int C, bool TRAIN> __host__ __device__ constexpr size_t freq_smem_bytes() {
  return sizeof(float) * (kRows * tile_ld(C) + ff_tail_floats<C>() + kRows * (3 * C + 1) +
                          kRows * (C / kHeadDim) + (TRAIN ? pmask_floats<C>() : 0));
}

// On entry, behind a barrier: y holds the tile's x (kRows x tile_ld(C)
// floats) and g its normed rows round_T(rmsnorm(x) * agamma). On exit,
// behind a barrier: y holds y1, g the gated attention output
// round_T(round_T(o) * gate), qkv (kRows x (3C + 1)) the rounded q and k
// after RoPE and v, gate (kRows x C/32) the rounded gates. ws:
// stage_floats(C) floats. TRAIN: dropout `drop` on the probabilities
// (pmask: pmask_floats<C>() floats, filled here) and after the out
// projection (coordinates: row of the flattened tensor, column). Tiles start
// on item boundaries.
template <int C, typename T, bool TRAIN>
__device__ __forceinline__ void freq_attention(
    float* y, float* g, float* qkv, float* gate, float* ws, float* pmask,
    const T* __restrict__ wqkv, const float* __restrict__ wg, const float* __restrict__ gb,
    const T* __restrict__ wout, const float* __restrict__ cosv, const float* __restrict__ sinv,
    int F, float qscale, int64_t row0, const Dropout& drop) {
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
  if constexpr (TRAIN) {
    // keep factors of (item (row0 + r) / F, head, query r % F, key)
    const int g4 = (F + 3) / 4;
    for (int e = tid; e < kRows * H * g4; e += kThreads) {
      const int r = e / (H * g4), h = (e / g4) % H, c4 = e % g4;
      float f[4];
      keep4(drop, kSiteAttnProbs, (uint32_t)((row0 + r) / F), h, r % F, c4, f);
      for (int c = 0; c < 4 && 4 * c4 + c < F; ++c) pmask[(r * H + h) * F + 4 * c4 + c] = f[c];
    }
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
  __syncthreads();  // also orders the gate and mask writes before their reads below

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
    if constexpr (TRAIN) {
      for (int j = first; j < first + F; ++j) {
        const float* kr = qkv + j * ldq + C + h * kHeadDim;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) s += qv[d] * kr[d];
        m = fmaxf(m, s);
      }
      const float* pm = pmask + (r * H + h) * F;
      for (int j = first; j < first + F; ++j) {
        const float* kr = qkv + j * ldq + C + h * kHeadDim;
        const float* vr = kr + C;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) s += qv[d] * kr[d];
        const float p = exp2f(s - m);
        l += p;
        const float pd = round_to<T>(p * pm[j - first]);
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) o[d] += pd * vr[d];
      }
    } else {
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
  // the thread that owns it); in training times the output keep factor
  for (int n0 = 0; n0 < C; n0 += NT) {
    float acc[2][NT / 16];
    zero(acc);
    mm_acc<NT, T>(acc, g, ld, wout, C, n0, C, ws);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < NT / 32; ++j) {
        const int c0 = n0 + 2 * cp + 32 * j;  // even: both columns in one Philox group
        float f[4] = {1.f, 1.f, 1.f, 1.f};
        if constexpr (TRAIN) keep4(drop, kSiteAttnOut, 0, 0, (uint32_t)(row0 + r), c0 >> 2, f);
#pragma unroll
        for (int e = 0; e < 2; ++e) y[r * ld + c0 + e] += acc[i][2 * j + e] * f[(c0 & 3) + e];
      }
    }
  }
  __syncthreads();
}

}  // namespace bt
