// The attention core's forward on the tensor cores, shared by the training
// forward of the time-axis attention branch (fused_time_train.cu, B4) and
// the eval time block (fused_time.cu, K2, as B4's instance at rate 0): per
// (item * head, 64 queries), two walks over 64-key tiles on the 4-warp tile
// of attn_tc.cuh. Walk 1 takes each query's maximum m of S = Q K^T; walk 2
// takes p = exp2(S s - m) (s = 32^-0.5 log2(e) on the float32 product, not
// on a rounded q), the probability mask, round_T(p f) repacked into A
// fragments and O += P V; l sums the undropped, unrounded p (the TPU kernel
// sums the rounded p; the two differ by bf16's rounding of p, well inside
// the bf16 limit). p is rounded against its row's final maximum, as in the
// plain versions. The result is written as round_T(o * gate), an operand of
// the out projection. Operands of P bf16 parts (attn_tc.cuh's helpers, shared
// with the backward's core in fused_time_train.cu and the flash kernels):
// float32 takes two (a_lo b_hi + a_hi b_lo + a_hi b_hi, about 16 significant
// bits), bf16 one.
#pragma once

#include "attn_tc.cuh"
#include "tc_product.cuh"

namespace {

constexpr int kHD = bt::kHeadDim;                          // 32
constexpr float kScale = 0.17677669529663688f;             // 32^-0.5
constexpr float kQScale = kScale * 1.4426950408889634f;    // 32^-0.5 * log2(e)

// -- the attention core ----------------------------------------------------------

namespace tc {

// q, k, v: (items * H, n, 32) operands (parts `lo` apart); go (items, n, C)
// operand (parts go_lo apart). The training forward (EVAL false) also writes
// o (items, n, C) float32 and m, l (items * H, n) for its backward; at eval
// (B4's rate-0 instance as K2's attention) only go is written, and no mask
// bits are drawn.
template <int P, bool EVAL>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, int64_t lo, const float* __restrict__ gates,
                    float* __restrict__ o, bf16* __restrict__ go, int64_t go_lo,
                    float* __restrict__ mrow, float* __restrict__ lrow, int n, int H,
                    bt::Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  Tile<kHD>* ks = reinterpret_cast<Tile<kHD>*>(smem_b);
  Tile<kHD>* vs = ks + kStages * P;
  const int bh = blockIdx.x, item = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kRows + 16 * (threadIdx.x >> 5);
  const size_t base = (size_t)bh * n * kHD;
  const int tiles = (n + kTile - 1) / kTile;
  const bool on = !EVAL && drop.on;
  uint32_t qa[P][kHD / 16][4];
  load_parts<kHD, P>(qa, q + base, lo, row0, n);

  // walk 1: each query's maximum score
  float smax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) stage_parts<kHD, P>(ks + st * P, k + base, lo, st * kTile, n);
    bt::cp_async_commit();
  }
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile;
    bt::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < tiles)
      stage_parts<kHD, P>(ks + ((it + kStages - 1) % kStages) * P, k + base, lo,
                     k0 + (kStages - 1) * kTile, n);
    bt::cp_async_commit();
    float s[8][4];
    scores<kHD, P>(s, qa, ks + (it % kStages) * P);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + 8 * j + 2 * t + e < n) {
          smax[0] = fmaxf(smax[0], s[j][e]);
          smax[1] = fmaxf(smax[1], s[j][2 + e]);
        }
  }
  // scaling is monotonic, so this is the maximum of the scaled scores
  const float m[2] = {quad_max(smax[0]) * kQScale, quad_max(smax[1]) * kQScale};
  bt::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the buffers walk 2 restages

  // walk 2: p, l and O += P V
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) {
      stage_parts<kHD, P>(ks + st * P, k + base, lo, st * kTile, n);
      stage_parts<kHD, P>(vs + st * P, v + base, lo, st * kTile, n);
    }
    bt::cp_async_commit();
  }
  float acc[kHD / 8][4] = {};
  float l[2] = {0.f, 0.f};
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile, buf = it % kStages;
    bt::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < tiles) {
      const int nb = (it + kStages - 1) % kStages;
      stage_parts<kHD, P>(ks + nb * P, k + base, lo, k0 + (kStages - 1) * kTile, n);
      stage_parts<kHD, P>(vs + nb * P, v + base, lo, k0 + (kStages - 1) * kTile, n);
    }
    bt::cp_async_commit();
    float s[8][4];
    scores<kHD, P>(s, qa, ks + buf * P);
    uint32_t bits[2] = {0u, 0u};
    if (on) keep_bits(drop, item, h, row0 + g, k0, bits);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = k0 + 8 * j + 2 * t + e < n;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float p = in ? fast_exp2(s[j][2 * hh + e] * kQScale - m[hh]) : 0.f;
          l[hh] += p;
          s[j][2 * hh + e] = on ? p * keep_factor(drop, bits[hh], 2 * j + e) : p;
        }
      }
    uint32_t pa[P][4][4];
    to_parts<P>(pa, s);
    accumulate<kHD, P>(acc, pa, vs + buf * P);
  }
  const float lt[2] = {quad_sum(l[0]), quad_sum(l[1])};
  const int C = H * kHD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + g + 8 * hh;
    if (r >= n) continue;
    const int64_t row = (int64_t)item * n + r;
    if (!EVAL && t == 0) {
      mrow[(size_t)bh * n + r] = m[hh];
      lrow[(size_t)bh * n + r] = lt[hh];
    }
    const float gate = gates[row * H + h];
#pragma unroll
    for (int c = 0; c < kHD / 8; ++c) {
      const int64_t at = row * C + h * kHD + 8 * c + 2 * t;
      const float v0 = acc[c][2 * hh] / lt[hh], v1 = acc[c][2 * hh + 1] / lt[hh];
      if (!EVAL) *reinterpret_cast<float2*>(o + at) = make_float2(v0, v1);
      mm::store2<P>(go + at, go_lo, v0 * gate, v1 * gate);
    }
  }
}

}  // namespace tc
}  // namespace
