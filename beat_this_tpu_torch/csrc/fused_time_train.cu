// The time-axis attention residual branch for training, forward and backward:
//   branch = drop_out(W_out (gate * drop_p(softmax(rope(q) rope(k)^T / sqrt(32))) v)),
// with q, k, v = W_qkv rmsnorm(x), gate = sigmoid(W_g rmsnorm(x) + b_g) per
// head, and the dropout masks drawn from Philox (philox.cuh) by element
// coordinates, so the backward regenerates the forward's masks.
//
// Replaces beat_this_tpu/ops/fused_time.py:_attn_train_kernel (forward,
// reached through _fused_time_attn_train) and :_attn_train_bwd_kernel
// (backward, through _fused_time_attn_train_bwd). The TPU kernels hold whole
// (n, n) score tiles per head and accumulate across a sequential
// (items, head_groups) grid. A block here has 227 KB of shared memory and
// blocks run in parallel, so the branch is split into launches with O(n C)
// intermediates in device memory and never an (n, n) tensor:
//
// forward
//   1. time_qkv (time_qkv.cuh): norm, q/k/v, RoPE, gates, as at eval.
//   2. attn_fwd: per (item * head, 128 queries), online-softmax attention
//      over 64-key tiles, one query per thread. The probability mask scales
//      the unnormalized p before the PV product while the row sum l stays
//      undropped (torch's dropout of the normalized probabilities). Saves
//      the row max m and sum l and the normalized, ungated output o.
//   3. attn_out: per 32-row tile, round_T(o * gate) times W_out, then the
//      output mask.
// backward
//   a. bwd_pre:  per 32-row tile, d_branch = dout * output mask, d_go =
//      d_branch W_out, the gate pullback d_z, and per (row, head) dO / l and
//      delta = rowsum(dO / l * o).
//   b. bwd_dq:   per (item * head, 128 queries), a flash backward over key
//      tiles: ds = p (dp * mask - delta), dq = ds k, then the inverse RoPE.
//   c. bwd_dkv:  per (item * head, 128 keys), the same over query tiles:
//      dv = (p * mask)^T dO / l, dk = ds^T q, inverse RoPE (dk and dv reduce
//      over queries, so they get their own key-major pass, not atomics).
//   d. bwd_post: per 32-row tile, d_gn = dq|dk|dv W_qkv + d_z W_g, then the
//      RMSNorm backward for dx, and per-tile partials of dgamma, dW_g, db_g.
//   e. wgrad:    per (32 output rows of W_qkv or W_out, group of row
//      tiles), dW_qkv = d_qkv^T g and dW_out = d_branch^T (o * gate) over the
//      group's rows; one partial per group.
//   f. sum_partials: fixed-order sums of the partials (two runs give the
//      same bits).
//
// Bound on the H100: arithmetic. Attention costs 4 n^2 32 multiply-adds per
// (item, head) in the forward and about 2.5 times that in the backward,
// against O(n 32) bytes. Products are float32 FMAs on the SIMT cores;
// bfloat16 values are widened on load and rounded where the TPU kernel
// rounds (g, q/k/v, the dropped probabilities, the gated output, d_branch,
// dO / l, ds, and d_q/d_k/d_v before the weight products).
#include "time_qkv.cuh"

namespace {

constexpr float kScale = 0.17677669529663688f;            // 32^-0.5
constexpr float kQScale = kScale * 1.4426950408889634f;   // 32^-0.5 * log2(e)
constexpr int kDQ = kQTile / 2;  // queries per staged tile in the key-major pass
constexpr int kWChunk = 32;      // output rows per weight-gradient block

template <typename T>
__global__ void __launch_bounds__(kQTile)
    attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    float* __restrict__ o, float* __restrict__ mrow, float* __restrict__ lrow,
                    int n, int H, bt::Dropout drop) {
  __shared__ float ks[kKTile][bt::kHeadDim];
  __shared__ float vs[kKTile][bt::kHeadDim];
  const int bh = blockIdx.x, item = bh / H, h = bh % H;
  const int t = blockIdx.y * kQTile + threadIdx.x;
  const size_t base = (size_t)bh * n * bt::kHeadDim;
  float qr[bt::kHeadDim], acc[bt::kHeadDim];
#pragma unroll
  for (int d = 0; d < bt::kHeadDim; ++d) {
    qr[d] = t < n ? bt::to_f(q[base + (size_t)t * bt::kHeadDim + d]) * kQScale : 0.f;
    acc[d] = 0.f;
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
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < bt::kHeadDim; ++d) a += qr[d] * ks[j][d];
      s[j] = j < kn ? a : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float corr = exp2f(m - mt);
    l *= corr;
#pragma unroll
    for (int d = 0; d < bt::kHeadDim; ++d) acc[d] *= corr;
#pragma unroll
    for (int jg = 0; jg < kKTile / 4; ++jg) {
      float f[4];
      bt::keep4(drop, bt::kSiteAttnProbs, item, h, t, (k0 >> 2) + jg, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * jg + e] - mt);
        l += p;
        const float a = bt::round_to<T>(p * f[e]);
#pragma unroll
        for (int d = 0; d < bt::kHeadDim; ++d) acc[d] += a * vs[4 * jg + e][d];
      }
    }
    m = mt;
    __syncthreads();
  }
  if (t >= n) return;
  mrow[(size_t)bh * n + t] = m;
  lrow[(size_t)bh * n + t] = l;
  float* dst = o + ((size_t)item * n + t) * (H * bt::kHeadDim) + h * bt::kHeadDim;
#pragma unroll
  for (int d = 0; d < bt::kHeadDim; ++d) dst[d] = acc[d] / l;
}

// Tile of round_T(o * gate), zero past nrows. Ends with a barrier.
template <int C, typename T>
__device__ __forceinline__ void load_gated(const float* __restrict__ o,
                                           const float* __restrict__ gates, float* dst,
                                           int64_t row0, int nrows) {
  constexpr int H = C / bt::kHeadDim;
  for (int e = threadIdx.x; e < bt::kRows * C; e += bt::kThreads) {
    const int r = e / C, c = e % C;
    dst[r * bt::tile_ld(C) + c] =
        r < nrows ? bt::round_to<T>(o[(row0 + r) * C + c] *
                                    gates[(row0 + r) * H + c / bt::kHeadDim])
                  : 0.f;
  }
  __syncthreads();
}

template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    attn_out_kernel(const float* __restrict__ o, const float* __restrict__ gates,
                    const T* __restrict__ wout, T* __restrict__ out, int64_t rows,
                    bt::Dropout drop) {
  constexpr int ld = bt::tile_ld(C), NT = qkv_cols<C>();
  extern __shared__ float smem[];
  float* a = smem;
  float* ws = a + bt::kRows * ld;
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
  const int64_t row0 = (int64_t)blockIdx.x * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);
  load_gated<C, T>(o, gates, a, row0, nrows);
  for (int n0 = 0; n0 < C; n0 += NT) {
    float acc[2][NT / 16];
    bt::zero(acc);
    bt::mm_acc<NT, T>(acc, a, ld, wout, C, n0, C, ws);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg + 16 * i;
      if (r >= nrows) continue;
#pragma unroll
      for (int j = 0; j < NT / 32; ++j) {
        const int c0 = n0 + 2 * cp + 32 * j;
        float f[4];
        bt::keep4(drop, bt::kSiteAttnOut, 0, 0, (uint32_t)(row0 + r), c0 >> 2, f);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          out[(row0 + r) * C + c0 + e] = bt::from_f<T>(acc[i][2 * j + e] * f[(c0 & 3) + e]);
      }
    }
  }
}

template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    attn_bwd_pre_kernel(const T* __restrict__ dout, const float* __restrict__ o,
                        const float* __restrict__ gates, const float* __restrict__ lrow,
                        const T* __restrict__ wout, T* __restrict__ dbb,
                        float* __restrict__ dO, float* __restrict__ dz,
                        float* __restrict__ delta, int64_t rows, int n, bt::Dropout drop) {
  constexpr int H = C / bt::kHeadDim, ld = bt::tile_ld(C), NT = qkv_cols<C>();
  extern __shared__ float smem[];
  float* a = smem;
  float* ws = a + bt::kRows * ld;
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
  const int64_t row0 = (int64_t)blockIdx.x * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);

  for (int e = tid; e < bt::kRows * C; e += bt::kThreads) {
    const int r = e / C, c = e % C;
    float val = 0.f;
    if (r < nrows) {
      const int64_t at = (row0 + r) * C + c;
      val = bt::round_to<T>(bt::to_f(dout[at]) *
                            bt::keep1(drop, bt::kSiteAttnOut, 0, 0, (uint32_t)(row0 + r), c));
      dbb[at] = bt::from_f<T>(val);
    }
    a[r * ld + c] = val;
  }
  __syncthreads();

  for (int n0 = 0; n0 < C; n0 += NT) {
    float acc[2][NT / 16];
    bt::zero(acc);
    bt::mm_acc_t<NT, T>(acc, a, ld, wout, C, n0, C, ws);  // d_go = d_branch W_out
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg + 16 * i;
      const bool ok = r < nrows;
      const int64_t row = row0 + r, item = row / n;
      const int t = (int)(row % n);
#pragma unroll
      for (int j = 0; j < NT / 32; ++j) {
        const int h = (n0 + 32 * j) / bt::kHeadDim;
        const size_t bht = ((size_t)item * H + h) * n + t;
        const float gate = ok ? gates[row * H + h] : 0.f;
        const float l = ok ? lrow[bht] : 1.f;
        float zo = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 2 * cp + e;
          const float dgo = acc[i][2 * j + e];
          zo += dgo * (ok ? o[row * C + n0 + 32 * j + d] : 0.f);
          if (ok) dO[bht * bt::kHeadDim + d] = dgo * gate / l;
        }
#pragma unroll
        for (int off = 8; off; off >>= 1) zo += __shfl_xor_sync(0xffffffffu, zo, off);
        if (ok && cp == 0) {
          dz[row * H + h] = zo * gate * (1.f - gate);
          delta[bht] = zo * gate / l;
        }
      }
    }
  }
}

// Inverse RoPE (the transpose of the rotation) of interleaved pairs at
// position t, times the softmax scale, stored to dst[0..31] as T.
template <typename T>
__device__ __forceinline__ void store_rope_inv(const float (&g)[bt::kHeadDim],
                                               const float* __restrict__ cosv,
                                               const float* __restrict__ sinv, int t, T* dst) {
#pragma unroll
  for (int d = 0; d < bt::kHeadDim; d += 2) {
    const float cs = cosv[t * (bt::kHeadDim / 2) + d / 2];
    const float sn = sinv[t * (bt::kHeadDim / 2) + d / 2];
    dst[d] = bt::from_f<T>((g[d] * cs + g[d + 1] * sn) * kScale);
    dst[d + 1] = bt::from_f<T>((g[d + 1] * cs - g[d] * sn) * kScale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kQTile)
    attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ dO,
                       const float* __restrict__ mrow, const float* __restrict__ delta,
                       const float* __restrict__ cosv, const float* __restrict__ sinv,
                       T* __restrict__ dqkv, int n, int H, bt::Dropout drop) {
  __shared__ float ks[kKTile][bt::kHeadDim];
  __shared__ float vs[kKTile][bt::kHeadDim];
  const int bh = blockIdx.x, item = bh / H, h = bh % H;
  const int t = blockIdx.y * kQTile + threadIdx.x;
  const bool ok = t < n;
  const size_t base = (size_t)bh * n * bt::kHeadDim;
  float qr[bt::kHeadDim], dol[bt::kHeadDim], dq[bt::kHeadDim];
#pragma unroll
  for (int d = 0; d < bt::kHeadDim; ++d) {
    qr[d] = ok ? bt::to_f(q[base + (size_t)t * bt::kHeadDim + d]) * kQScale : 0.f;
    dol[d] = ok ? bt::round_to<T>(dO[base + (size_t)t * bt::kHeadDim + d]) : 0.f;
    dq[d] = 0.f;
  }
  const float m = ok ? mrow[(size_t)bh * n + t] : 0.f;
  const float dl = ok ? delta[(size_t)bh * n + t] : 0.f;
  for (int k0 = 0; k0 < n; k0 += kKTile) {
    for (int e = threadIdx.x; e < kKTile * bt::kHeadDim; e += kQTile) {
      const int r = e / bt::kHeadDim, d = e % bt::kHeadDim;
      const bool in = k0 + r < n;
      ks[r][d] = in ? bt::to_f(k[base + (size_t)(k0 + r) * bt::kHeadDim + d]) : 0.f;
      vs[r][d] = in ? bt::to_f(v[base + (size_t)(k0 + r) * bt::kHeadDim + d]) : 0.f;
    }
    __syncthreads();
    const int kn = min(kKTile, n - k0);
    for (int jg = 0; jg < kKTile / 4; ++jg) {
      float f[4];
      bt::keep4(drop, bt::kSiteAttnProbs, item, h, t, (k0 >> 2) + jg, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * jg + e;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < bt::kHeadDim; ++d) {
          s += qr[d] * ks[j][d];
          dp += dol[d] * vs[j][d];
        }
        const float p = j < kn ? exp2f(s - m) : 0.f;
        const float ds = bt::round_to<T>(p * (dp * f[e] - dl));
#pragma unroll
        for (int d = 0; d < bt::kHeadDim; ++d) dq[d] += ds * ks[j][d];
      }
    }
    __syncthreads();
  }
  if (!ok) return;
  const int C = H * bt::kHeadDim;
  store_rope_inv<T>(dq, cosv, sinv, t, dqkv + ((size_t)item * n + t) * 3 * C + h * bt::kHeadDim);
}

template <typename T>
__global__ void __launch_bounds__(kQTile)
    attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ dO,
                        const float* __restrict__ mrow, const float* __restrict__ delta,
                        const float* __restrict__ cosv, const float* __restrict__ sinv,
                        T* __restrict__ dqkv, int n, int H, bt::Dropout drop) {
  __shared__ float qs[kDQ][bt::kHeadDim];   // q * scale * log2(e), as the forward scores
  __shared__ float qu[kDQ][bt::kHeadDim];   // q
  __shared__ float dos[kDQ][bt::kHeadDim];  // round_T(dO / l)
  __shared__ float ms[kDQ], dls[kDQ];
  __shared__ uint8_t keepb[kDQ][kQTile / 4];  // mask bits of 4 keys per byte
  const int bh = blockIdx.x, item = bh / H, h = bh % H, tl = threadIdx.x;
  const int kb0 = blockIdx.y * kQTile, j = kb0 + tl;
  const bool ok = j < n;
  const size_t base = (size_t)bh * n * bt::kHeadDim;
  float kr[bt::kHeadDim], vr[bt::kHeadDim], dk[bt::kHeadDim], dv[bt::kHeadDim];
#pragma unroll
  for (int d = 0; d < bt::kHeadDim; ++d) {
    kr[d] = ok ? bt::to_f(k[base + (size_t)j * bt::kHeadDim + d]) : 0.f;
    vr[d] = ok ? bt::to_f(v[base + (size_t)j * bt::kHeadDim + d]) : 0.f;
    dk[d] = dv[d] = 0.f;
  }
  for (int q0 = 0; q0 < n; q0 += kDQ) {
    for (int e = tl; e < kDQ * bt::kHeadDim; e += kQTile) {
      const int i = e / bt::kHeadDim, d = e % bt::kHeadDim;
      const bool in = q0 + i < n;
      const size_t at = base + (size_t)(q0 + i) * bt::kHeadDim + d;
      const float qv = in ? bt::to_f(q[at]) : 0.f;
      qu[i][d] = qv;
      qs[i][d] = qv * kQScale;
      dos[i][d] = in ? bt::round_to<T>(dO[at]) : 0.f;
    }
    for (int i = tl; i < kDQ; i += kQTile) {
      const bool in = q0 + i < n;
      ms[i] = in ? mrow[(size_t)bh * n + q0 + i] : 0.f;
      dls[i] = in ? delta[(size_t)bh * n + q0 + i] : 0.f;
    }
    if (drop.on) {
      for (int g = tl; g < kDQ * (kQTile / 4); g += kQTile) {
        const int i = g / (kQTile / 4), kg = g % (kQTile / 4);
        const uint4 b = bt::philox4x32_10(
            make_uint4((kb0 >> 2) + kg, q0 + i, item, (bt::kSiteAttnProbs << 16) | h), drop.seed,
            drop.salt);
        keepb[i][kg] = (uint8_t)((b.x < drop.thr) | ((b.y < drop.thr) << 1) |
                                 ((b.z < drop.thr) << 2) | ((b.w < drop.thr) << 3));
      }
    }
    __syncthreads();
    const int qn = min(kDQ, n - q0);
    for (int i = 0; i < qn; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < bt::kHeadDim; ++d) {
        s += qs[i][d] * kr[d];
        dp += dos[i][d] * vr[d];
      }
      const float f = !drop.on ? 1.f : ((keepb[i][tl >> 2] >> (tl & 3)) & 1) ? drop.scale : 0.f;
      const float p = exp2f(s - ms[i]);
      const float a = bt::round_to<T>(p * f);
      const float ds = bt::round_to<T>(p * (dp * f - dls[i]));
#pragma unroll
      for (int d = 0; d < bt::kHeadDim; ++d) {
        dv[d] += a * dos[i][d];
        dk[d] += ds * qu[i][d];
      }
    }
    __syncthreads();
  }
  if (!ok) return;
  const int C = H * bt::kHeadDim;
  T* row = dqkv + ((size_t)item * n + j) * 3 * C + h * bt::kHeadDim;
  store_rope_inv<T>(dk, cosv, sinv, j, row + C);
#pragma unroll
  for (int d = 0; d < bt::kHeadDim; ++d) row[2 * C + d] = bt::from_f<T>(dv[d]);
}

template <int C>
__host__ __device__ constexpr int post_smem_floats() {
  return 2 * bt::kRows * bt::tile_ld(C) + bt::stage_floats(C) +
         bt::kRows * (C / bt::kHeadDim) + bt::kRows;
}

template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    attn_bwd_post_kernel(const T* __restrict__ x, const float* __restrict__ agamma,
                         const T* __restrict__ wqkv, const float* __restrict__ wg,
                         const T* __restrict__ dqkv, const float* __restrict__ dz,
                         T* __restrict__ dx, float* __restrict__ dgp, float* __restrict__ dwgp,
                         float* __restrict__ dgbp, int64_t rows) {
  constexpr int H = C / bt::kHeadDim, ld = bt::tile_ld(C);
  extern __shared__ float smem[];
  float* t1 = smem;                 // x, then the float32 normed rows gn
  float* t2 = t1 + bt::kRows * ld;  // one of d_q / d_k / d_v, then dgamma's products
  float* ws = t2 + bt::kRows * ld;
  float* dzs = ws + bt::stage_floats(C);
  float* rn = dzs + bt::kRows * H;
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t row0 = (int64_t)blockIdx.x * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);
  const float sc = sqrtf((float)C);

  float acc[2][C / 16];
  bt::zero(acc);
  for (int sec = 0; sec < 3; ++sec) {
    for (int e = tid; e < bt::kRows * C; e += bt::kThreads) {
      const int r = e / C, c = e % C;
      t2[r * ld + c] = r < nrows ? bt::to_f(dqkv[(row0 + r) * 3 * C + sec * C + c]) : 0.f;
    }
    __syncthreads();
    bt::mm_acc_t<C, T>(acc, t2, ld, wqkv + (size_t)sec * C * C, C, 0, C, ws);
  }
  for (int e = tid; e < bt::kRows * H; e += bt::kThreads) {
    const int r = e / H;
    dzs[e] = r < nrows ? dz[(row0 + r) * H + e % H] : 0.f;
  }
  bt::load_rows<C, T>(x, t1, row0, nrows);
  for (int r = warp; r < bt::kRows; r += bt::kThreads / 32) {
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) ss += t1[r * ld + c] * t1[r * ld + c];
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) rn[r] = fmaxf(sqrtf(ss), 1e-12f);
  }
  __syncthreads();

  // acc += d_z W_g; then dx = (w - n (n . w)) / r with w = d_gn gamma sqrt(C)
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg + 16 * i;
#pragma unroll
    for (int j = 0; j < C / 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * cp + 32 * j + e;
        float g = acc[i][2 * j + e];
        for (int h = 0; h < H; ++h) g += dzs[r * H + h] * wg[h * C + col];
        acc[i][2 * j + e] = g;
        const float n = t1[r * ld + col] / rn[r];
        s[i] += n * g * agamma[col] * sc;
        t2[r * ld + col] = g * n * sc;
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
        const float n = t1[r * ld + col] / rn[r];
        const float w = acc[i][2 * j + e] * agamma[col] * sc;
        dx[(row0 + r) * C + col] = bt::from_f<T>((w - n * s[i]) / rn[r]);
      }
  }
  __syncthreads();
  for (int c = tid; c < C; c += bt::kThreads) {
    float sum = 0.f;
    for (int r = 0; r < bt::kRows; ++r) sum += t2[r * ld + c];
    dgp[blockIdx.x * (int64_t)C + c] = sum;
  }
  for (int e = tid; e < bt::kRows * C; e += bt::kThreads) {
    const int r = e / C, c = e % C;
    t1[r * ld + c] = t1[r * ld + c] / rn[r] * sc * agamma[c];
  }
  __syncthreads();
  for (int e = tid; e < H * C; e += bt::kThreads) {
    const int h = e / C, c = e % C;
    float sum = 0.f;
    for (int r = 0; r < bt::kRows; ++r) sum += dzs[r * H + h] * t1[r * ld + c];
    dwgp[blockIdx.x * (int64_t)H * C + e] = sum;
  }
  if (tid < H) {
    float sum = 0.f;
    for (int r = 0; r < bt::kRows; ++r) sum += dzs[r * H + tid];
    dgbp[blockIdx.x * H + tid] = sum;
  }
}

template <int C>
__host__ __device__ constexpr int wgrad_smem_floats() {
  return bt::kRows * bt::tile_ld(C) + bt::kRows * (kWChunk + 1);
}

// Block (cb, g): output rows cb * 32 .. cb * 32 + 31 of the stacked
// [dW_qkv (3C, C); dW_out (C, C)] over row-tile group g.
template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    attn_wgrad_kernel(const T* __restrict__ x, const float* __restrict__ agamma,
                      const T* __restrict__ dqkv, const float* __restrict__ o,
                      const float* __restrict__ gates, const T* __restrict__ dbb,
                      float* __restrict__ wp, int64_t rows, int tiles_per_group) {
  constexpr int ld = bt::tile_ld(C), cl = kWChunk + 1, NI = C / 32;
  extern __shared__ float smem[];
  float* R = smem;
  float* L = R + bt::kRows * ld;
  const int tid = threadIdx.x, cb = blockIdx.x, g = blockIdx.y;
  const bool is_qkv = cb < 3 * C / kWChunk;
  const int64_t tiles = (rows + bt::kRows - 1) / bt::kRows;
  const int64_t t_end = min((int64_t)(g + 1) * tiles_per_group, tiles);
  float acc[4][NI];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[a][i] = 0.f;

  for (int64_t t = (int64_t)g * tiles_per_group; t < t_end; ++t) {
    const int64_t row0 = t * bt::kRows;
    const int nrows = bt::tile_rows(rows, row0);
    if (is_qkv) {
      bt::load_rows<C, T>(x, R, row0, nrows);
      bt::rms_rows<C, true, T>(R, R, ld, agamma);
    } else {
      load_gated<C, T>(o, gates, R, row0, nrows);
    }
    for (int e = tid; e < bt::kRows * kWChunk; e += bt::kThreads) {
      const int r = e / kWChunk, l = e % kWChunk;
      float val = 0.f;
      if (r < nrows)
        val = bt::to_f(is_qkv ? dqkv[(row0 + r) * 3 * C + cb * kWChunk + l]
                              : dbb[(row0 + r) * C + (cb - 3 * C / kWChunk) * kWChunk + l]);
      L[r * cl + l] = val;
    }
    __syncthreads();
    bt::outer_acc<NI>(acc, L, cl, R, ld);
    __syncthreads();
  }
  const int lane = tid & 31, l0 = 4 * (tid >> 5);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < NI; ++i)
      wp[(size_t)g * 4 * C * C + (size_t)(cb * kWChunk + l0 + a) * C + lane + 32 * i] =
          acc[a][i];
}

template <int C, typename T>
cudaError_t launch_fwd(const void* x, const void* agamma, const void* wqkv, const void* wg,
                       const void* gb, const void* wout, const void* cosv, const void* sinv,
                       void* q, void* k, void* v, void* gates, void* o, void* mrow, void* lrow,
                       void* out, int items, int n, bt::Dropout drop, cudaStream_t stream) {
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
  attn_fwd_kernel<T><<<grid, kQTile, 0, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                  (float*)o, (float*)mrow, (float*)lrow, n, H,
                                                  drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_out = sizeof(float) * (bt::kRows * ld + bt::stage_floats(qkv_cols<C>()));
  auto k3 = attn_out_kernel<C, T>;
  if ((err = bt::allow_smem(k3, smem_out)) != cudaSuccess) return err;
  k3<<<tiles, bt::kThreads, smem_out, stream>>>((const float*)o, (const float*)gates,
                                                (const T*)wout, (T*)out, rows, drop);
  return cudaGetLastError();
}

template <int C, typename T>
cudaError_t launch_bwd(const void* x, const void* agamma, const void* wqkv, const void* wg,
                       const void* wout, const void* cosv, const void* sinv, const void* q,
                       const void* k, const void* v, const void* gates, const void* o,
                       const void* mrow, const void* lrow, const void* dout, void* dbb,
                       void* dO, void* dz, void* delta, void* dqkv, void* dx, void* dgamma,
                       void* dw, void* dwg, void* dgb, void* scratch, int items, int n,
                       int groups, bt::Dropout drop, cudaStream_t stream) {
  constexpr int H = C / bt::kHeadDim, ld = bt::tile_ld(C);
  const int64_t rows = (int64_t)items * n;
  const int64_t tiles = (rows + bt::kRows - 1) / bt::kRows;
  float* dgp = (float*)scratch;
  float* dwgp = dgp + tiles * C;
  float* dgbp = dwgp + tiles * H * C;
  float* wp = dgbp + tiles * H;

  const size_t smem_pre = sizeof(float) * (bt::kRows * ld + bt::stage_floats(qkv_cols<C>()));
  auto ka = attn_bwd_pre_kernel<C, T>;
  cudaError_t err = bt::allow_smem(ka, smem_pre);
  if (err != cudaSuccess) return err;
  ka<<<(unsigned)tiles, bt::kThreads, smem_pre, stream>>>(
      (const T*)dout, (const float*)o, (const float*)gates, (const float*)lrow,
      (const T*)wout, (T*)dbb, (float*)dO, (float*)dz, (float*)delta, rows, n, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 grid(items * H, (n + kQTile - 1) / kQTile);
  attn_bwd_dq_kernel<T><<<grid, kQTile, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)dO, (const float*)mrow,
      (const float*)delta, (const float*)cosv, (const float*)sinv, (T*)dqkv, n, H, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dkv_kernel<T><<<grid, kQTile, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)dO, (const float*)mrow,
      (const float*)delta, (const float*)cosv, (const float*)sinv, (T*)dqkv, n, H, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_post = sizeof(float) * post_smem_floats<C>();
  auto kd = attn_bwd_post_kernel<C, T>;
  if ((err = bt::allow_smem(kd, smem_post)) != cudaSuccess) return err;
  kd<<<(unsigned)tiles, bt::kThreads, smem_post, stream>>>(
      (const T*)x, (const float*)agamma, (const T*)wqkv, (const float*)wg, (const T*)dqkv,
      (const float*)dz, (T*)dx, dgp, dwgp, dgbp, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_w = sizeof(float) * wgrad_smem_floats<C>();
  auto ke = attn_wgrad_kernel<C, T>;
  if ((err = bt::allow_smem(ke, smem_w)) != cudaSuccess) return err;
  const int tpg = (int)((tiles + groups - 1) / groups);
  ke<<<dim3(4 * C / kWChunk, groups), bt::kThreads, smem_w, stream>>>(
      (const T*)x, (const float*)agamma, (const T*)dqkv, (const float*)o, (const float*)gates,
      (const T*)dbb, wp, rows, tpg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = bt::sum_partials(dgp, (float*)dgamma, (int)tiles, C, stream)) != cudaSuccess)
    return err;
  if ((err = bt::sum_partials(dwgp, (float*)dwg, (int)tiles, (int64_t)H * C, stream)) !=
      cudaSuccess)
    return err;
  if ((err = bt::sum_partials(dgbp, (float*)dgb, (int)tiles, H, stream)) != cudaSuccess)
    return err;
  return bt::sum_partials(wp, (float*)dw, groups, (int64_t)4 * C * C, stream);
}

#define BT_TIME_SWITCH(CALL)                 \
  switch (C) {                               \
    case 32: return CALL(32);                \
    case 64: return CALL(64);                \
    case 128: return CALL(128);              \
    case 256: return CALL(256);              \
    case 384: return CALL(384);              \
    case 512: return CALL(512);              \
    default: return cudaErrorInvalidValue;   \
  }

template <typename T>
cudaError_t dispatch_fwd(int C, const void* x, const void* agamma, const void* wqkv,
                         const void* wg, const void* gb, const void* wout, const void* cosv,
                         const void* sinv, void* q, void* k, void* v, void* gates, void* o,
                         void* mrow, void* lrow, void* out, int items, int n, bt::Dropout drop,
                         cudaStream_t s) {
#define BT_CALL(CC)                                                                          \
  launch_fwd<CC, T>(x, agamma, wqkv, wg, gb, wout, cosv, sinv, q, k, v, gates, o, mrow, lrow, \
                    out, items, n, drop, s)
  BT_TIME_SWITCH(BT_CALL)
#undef BT_CALL
}

template <typename T>
cudaError_t dispatch_bwd(int C, const void* x, const void* agamma, const void* wqkv,
                         const void* wg, const void* wout, const void* cosv, const void* sinv,
                         const void* q, const void* k, const void* v, const void* gates,
                         const void* o, const void* mrow, const void* lrow, const void* dout,
                         void* dbb, void* dO, void* dz, void* delta, void* dqkv, void* dx,
                         void* dgamma, void* dw, void* dwg, void* dgb, void* scratch, int items,
                         int n, int groups, bt::Dropout drop, cudaStream_t s) {
#define BT_CALL(CC)                                                                          \
  launch_bwd<CC, T>(x, agamma, wqkv, wg, wout, cosv, sinv, q, k, v, gates, o, mrow, lrow,   \
                    dout, dbb, dO, dz, delta, dqkv, dx, dgamma, dw, dwg, dgb, scratch, items, \
                    n, groups, drop, s)
  BT_TIME_SWITCH(BT_CALL)
#undef BT_CALL
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 for x (items, n, C), wqkv (3C, C), wout (C, C),
// out (items, n, C) and the saved q, k, v (items, C/32, n, 32); agamma, wg
// (C/32, C), gb, cos/sin (n, 16), gates (items * n, C/32), o (items, n, C),
// mrow and lrow (items * C/32, n) are float32. Dropout: keep iff the Philox
// bits < thr, kept values times scale; on == 0 turns it off.
extern "C" int bt_attn_train_fwd(int dtype, int C, const void* x, const void* agamma,
                                 const void* wqkv, const void* wg, const void* gb,
                                 const void* wout, const void* cosv, const void* sinv, void* q,
                                 void* k, void* v, void* gates, void* o, void* mrow, void* lrow,
                                 void* out, int items, int n, unsigned seed, unsigned salt,
                                 unsigned thr, float scale, int on, void* stream) {
  if (items <= 0 || n <= 0) return 0;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? dispatch_fwd<float>(C, x, agamma, wqkv, wg, gb, wout, cosv, sinv, q,
                                                k, v, gates, o, mrow, lrow, out, items, n, d, s)
               : dtype == 1
                   ? dispatch_fwd<__nv_bfloat16>(C, x, agamma, wqkv, wg, gb, wout, cosv, sinv, q,
                                                 k, v, gates, o, mrow, lrow, out, items, n, d, s)
                   : cudaErrorInvalidValue);
}

// The forward's inputs and saved tensors plus dout (items, n, C) in the
// dtype; scratch outputs dbb (items, n, C) and dqkv (items, n, 3C) in the
// dtype, dO (items, C/32, n, 32), dz (items * n, C/32) and delta
// (items * C/32, n) in float32; results dx (items, n, C) in the dtype and
// float32 dgamma (C), dw (4C, C) = [dW_qkv; dW_out], dwg (C/32, C), dgb
// (C/32). scratch: ceil(items * n / 32) * (C + C/32 * (C + 1)) +
// groups * 4 * C * C floats; 1 <= groups <= ceil(items * n / 32).
extern "C" int bt_attn_train_bwd(int dtype, int C, const void* x, const void* agamma,
                                 const void* wqkv, const void* wg, const void* wout,
                                 const void* cosv, const void* sinv, const void* q, const void* k,
                                 const void* v, const void* gates, const void* o,
                                 const void* mrow, const void* lrow, const void* dout, void* dbb,
                                 void* dO, void* dz, void* delta, void* dqkv, void* dx,
                                 void* dgamma, void* dw, void* dwg, void* dgb, void* scratch,
                                 int items, int n, int groups, unsigned seed, unsigned salt,
                                 unsigned thr, float scale, int on, void* stream) {
  if (items <= 0 || n <= 0) return 0;
  if (groups < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? dispatch_bwd<float>(C, x, agamma, wqkv, wg, wout, cosv, sinv, q, k, v, gates,
                                         o, mrow, lrow, dout, dbb, dO, dz, delta, dqkv, dx,
                                         dgamma, dw, dwg, dgb, scratch, items, n, groups, d, s)
               : dtype == 1
                   ? dispatch_bwd<__nv_bfloat16>(C, x, agamma, wqkv, wg, wout, cosv, sinv, q, k,
                                                 v, gates, o, mrow, lrow, dout, dbb, dO, dz,
                                                 delta, dqkv, dx, dgamma, dw, dwg, dgb, scratch,
                                                 items, n, groups, d, s)
                   : cudaErrorInvalidValue);
}
