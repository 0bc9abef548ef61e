// The feed-forward residual's training launches on the tensor cores, shared
// by fused_ff_train.cu (B8, B9) and fused_freq_train.cu (B7, whose FF half
// is B9's launches on the float32 rows x2):
//   out = x + drop_out(W2 drop_hid(gelu(W1 g + b1)) + b2),  g = rmsnorm(x) * gamma,
// with the dropout masks drawn from Philox (philox.cuh) by element
// coordinates (row of the (rows, C) view, column) under the caller's salt,
// so the backward regenerates the forward's masks. x (and dx) are of type X,
// the compute dtype T (float32 or bf16) sets the rounding points, and the
// operands have P parts (tc_product.cuh: bf16 1; float32 3 in B8 and B7, 2 in
// B9's own launches and at eval); X is T except in B7 and K2's tail, where it
// is float32.
//
// Every product runs on the staged product of tc_product.cuh (mma.sync,
// bf16 operands, float32 accumulators; float32 as bf16 products of split
// operands). The TPU kernels sum the weight gradients across their
// sequential grid; here blocks run in parallel, so the backward writes its
// hidden-width operands to scratch and takes the weight gradients as
// products over the rows.
//
// The forward's launches at dropout rate 0 are also the eval feed-forward:
// K1 (fused_ff.cu) on rows of T and the tail of K2 (fused_time.cu) on its
// float32 rows y1, both with two-part float32 operands.
//
// forward (B8), 4 launches (5 where the output product is taken in depth
// slices, at small row counts):
//   1. operands: W1^T and W2^T as bf16 operands;
//   2. pre:      per 128 rows, g = round_T(rmsnorm(x) gamma) as an operand;
//   3. hidden:   per (128 rows, 64 hidden units), pre1 = g W1^T; the
//                epilogue adds b1, applies the exact GELU and the hidden
//                mask and writes h1d = round_T(gelu(pre1 + b1) f) to scratch;
//   4. out:      h1d W2^T; the epilogue adds b2, applies the output mask,
//                adds x in float32 and rounds once into out.
// backward (B9), 7 launches and a share of the caller's sums launch:
//   1. operands: W1^T (and, split, W1 and W2 themselves) as bf16 operands;
//   2. pre:      per 128 rows, the row norms, g and d_y = round_T(dout *
//                output mask) as operands, and the tile's column sums of the
//                unrounded d_y (db2);
//   3. hidden:   pre1 = g W1^T and d_h1 = d_y W2 on one tile; its epilogue
//                draws the hidden mask once and writes h1d and d_pre1 =
//                round_T(d_h1 f gelu'(pre1 + b1)), with the tile's column
//                sums of the unrounded d_pre1 (db1);
//   4. d_g = d_pre1 W1 (float32, scratch);
//   5, 6. dW1 = d_pre1^T g and dW2 = d_y^T h1d, over groups of rows (one
//      float32 partial per group);
//   7. post:     per 128 rows, dx = dout + rmsnorm'(d_g) and the tile's
//                column sums for dgamma;
// then the per-tile and per-group partials summed in a fixed order in one
// launch (mm::column_sums), so two runs give the same bits (no float
// atomics). Scratch at C 512 and 12000 rows: forward 0.07 / 0.13 GB in bf16 /
// float32, backward 0.20 / 0.33 GB (the layouts below; the wrappers ask the
// library for the sizes).
//
// Bound on the H100: arithmetic at C 512 (two products of 2 rows C 4C FLOPs
// forward, five backward, against about 4 C values of each row read or
// written); at the frontend's C 32-128 the bytes of the scratch operands.
#pragma once

#include <algorithm>
#include <type_traits>

#include "tc_product.cuh"

namespace {
namespace ff {

using namespace mm;

constexpr int kHidN = 64;  // hidden units per block of the hidden pass

// out (+ blockIdx.z * out_step) = A B over the depth slice [z k_per,
// min((z + 1) k_per, k_end)) of z = blockIdx.z, for A (m_end x K) and B
// (K x n_end); element (m, n) at out[m * ldo + n], or with trans_out at
// out[n * ldo + m].
template <bool AM, int BN, int P>
__global__ void __launch_bounds__(bt::kThreads)
    ff_product_kernel(Operand A, Operand B, float* __restrict__ out, int64_t ldo,
                      int64_t out_step, int trans_out, int64_t m_end, int n_end, int64_t k_end,
                      int64_t k_per) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int64_t m0 = (int64_t)blockIdx.y * kTM, k0 = (int64_t)blockIdx.z * k_per;
  const int n0 = blockIdx.x * BN;
  float acc[2][BN / 16][4];
  product<AM, BN, P>(acc, A, B, m0, n0, k0, min(k0 + k_per, k_end), m_end, n_end,
                     reinterpret_cast<bf16*>(smem_b));
  store_product<BN>(acc, out + blockIdx.z * out_step, ldo, trans_out, m0, n0, m_end, n_end);
}

// The hidden pass over rows [m0, m0 + kTM) and hidden units [n0, n0 +
// kHidN): pre1 = g W1^T + b1 on the tensor cores, then h1d = round_T(gelu(pre1)
// f) for the hidden keep factors f, written to h1d (M columns, bf16 parts
// `lo` apart). BWD (B9) adds d_h1 = d_y W2 on the same tile, d_pre1 = d_h1 f
// gelu'(pre1) written rounded to dp, and the tile's column sums of the
// unrounded d_pre1 (db1).
template <int P, bool BWD>
__global__ void __launch_bounds__(bt::kThreads)
    ff_hidden_kernel(Operand G, Operand W1t, Operand DY, Operand W2, const float* __restrict__ b1,
                     bf16* __restrict__ dp, bf16* __restrict__ h1d, int64_t lo,
                     float* __restrict__ db1p, int64_t rows, int M, int C, bt::Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* smem = reinterpret_cast<bf16*>(smem_b);
  constexpr int NJ = kHidN / 16;
  const int64_t m0 = (int64_t)blockIdx.y * kTM;
  const int n0 = blockIdx.x * kHidN;
  float pre[2][NJ][4], dh[2][NJ][4];
  product<false, kHidN, P>(pre, G, W1t, m0, n0, 0, C, rows, M, smem);
  if constexpr (BWD) product<false, kHidN, P>(dh, DY, W2, m0, n0, 0, C, rows, M, smem);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp & 3), wn = (kHidN / 2) * (warp >> 2);
  float colsum[NJ][2] = {};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int64_t row = m0 + wm + 16 * mi + (lane >> 2);
      const int col = n0 + wn + 8 * j + 2 * (lane & 3);
      float f[2][2];
      row_keep(drop, bt::kSiteFFHidden, row, n0 + wn + 8 * j, f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = row + 8 * h;
        float hv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = pre[mi][j][2 * h + e] + b1[col + e];
          hv[e] = bt::gelu_exact(p) * f[h][e];
          if constexpr (BWD) {
            dv[e] = r < rows ? dh[mi][j][2 * h + e] * f[h][e] * bt::gelu_grad(p) : 0.f;
            colsum[j][e] += dv[e];
          }
        }
        if (r < rows) {
          store2<P>(h1d + r * M + col, lo, hv[0], hv[1]);
          if constexpr (BWD) store2<P>(dp + r * M + col, lo, dv[0], dv[1]);
        }
      }
    }
  if constexpr (BWD) {
    // column sums: over the 8 row groups of a warp, then over the 4 warps of
    // a column half, in a fixed order
    float* red = reinterpret_cast<float*>(smem_b);  // [4][kHidN]
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = colsum[j][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) red[(warp & 3) * kHidN + wn + 8 * j + 2 * lane + e] = v;
      }
    __syncthreads();
    if (threadIdx.x < kHidN) {
      const int c = threadIdx.x;
      db1p[blockIdx.y * (int64_t)M + n0 + c] =
          red[c] + red[kHidN + c] + red[2 * kHidN + c] + red[3 * kHidN + c];
    }
  }
}

// The forward's output product: out = x + (h1d W2^T + b2) times the output
// keep factors, in float32, rounded once to T (A: h1d, B: W2^T, operands of
// P parts; x of type X).
template <int BN, typename T, typename X, int P>
__global__ void __launch_bounds__(bt::kThreads)
    ff_out_kernel(Operand A, Operand B, const X* __restrict__ x, const float* __restrict__ b2,
                  T* __restrict__ out, int64_t rows, int C, int M, bt::Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int64_t m0 = (int64_t)blockIdx.y * kTM;
  const int n0 = blockIdx.x * BN;
  float acc[2][BN / 16][4];
  product<false, BN, P>(acc, A, B, m0, n0, 0, M, rows, C, reinterpret_cast<bf16*>(smem_b));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp & 3), wn = (BN / 2) * (warp >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int64_t row = m0 + wm + 16 * mi + (lane >> 2);
      const int col8 = n0 + wn + 8 * j, col = col8 + 2 * (lane & 3);
      float f[2][2];
      row_keep(drop, bt::kSiteFFOut, row, col8, f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t r = row + 8 * hh;
        if (r >= rows || col >= C) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t at = r * C + col + e;
          out[at] = bt::from_f<T>(bt::to_f(x[at]) + (acc[mi][j][2 * hh + e] + b2[col + e]) *
                                                        f[hh][e]);
        }
      }
    }
}

// Each lane's per-column sums acc (its NG groups of 4 columns) summed over
// the rows of the block into part[0 .. C), in a fixed order: over the lanes
// of one column group in a warp, then over the 8 warps. red: 8 C floats of
// shared memory, free again on return.
template <int C>
__device__ __forceinline__ void block_column_sums(float (&acc)[RowMap<C>::NG][4], float* red,
                                                  float* __restrict__ part) {
  using RM = RowMap<C>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane % RM::L;
#pragma unroll
  for (int i = 0; i < RM::NG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = acc[i][e];
#pragma unroll
      for (int o = RM::L; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < RM::L) red[warp * C + 4 * (q + RM::L * i) + e] = v;
    }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += bt::kThreads) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * C + c];
    part[c] = s;
  }
  __syncthreads();
}

// The output after an output product taken in S depth slices (partials
// `part`, S (rows, C) float32 sections): out = x + (the slices' sum, in
// order, + b2) times the output keep factors, in float32, rounded once to T;
// four columns a thread and step.
template <typename T, typename X>
__global__ void __launch_bounds__(bt::kThreads)
    ff_out_sum_kernel(const float* __restrict__ part, int S, const X* __restrict__ x,
                      const float* __restrict__ b2, T* __restrict__ out, int64_t rows, int C,
                      bt::Dropout drop) {
  const int64_t quads = rows * C / 4, step = rows * C;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < quads;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = e / (C / 4);
    const int c = 4 * (int)(e % (C / 4));
    const int64_t at = r * C + c;
    float4 a = *reinterpret_cast<const float4*>(part + at);
    for (int z = 1; z < S; ++z) {
      const float4 v = *reinterpret_cast<const float4*>(part + z * step + at);
      a.x += v.x, a.y += v.y, a.z += v.z, a.w += v.w;
    }
    float f[4];
    bt::row_keep4(drop, bt::kSiteFFOut, (uint32_t)r, c >> 2, f);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[at + i] = bt::from_f<T>(bt::to_f(x[at + i]) + (av[i] + b2[c + i]) * f[i]);
  }
}

// Before the products: g = round_T(rmsnorm(x) gamma) as a bf16 operand
// (parts `lo` apart). BWD adds each row's clamped norm rn, d_y =
// round_T(dout * output mask) as an operand and the block's column sums of
// the unrounded d_y (db2).
template <int C, typename T, typename X, bool BWD, int P>
__global__ void __launch_bounds__(bt::kThreads)
    ff_pre_kernel(const X* __restrict__ x, const float* __restrict__ gamma,
                  const T* __restrict__ dout, float* __restrict__ rn, bf16* __restrict__ g,
                  bf16* __restrict__ dy, int64_t lo, float* __restrict__ db2p, int64_t rows,
                  bt::Dropout drop) {
  using RM = RowMap<C>;
  __shared__ float red[BWD ? 8 * C : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane % RM::L;
  const float sc = sqrtf((float)C);
  float acc[RM::NG][4] = {};
  for (int rr = warp * RM::RPW + lane / RM::L; rr < kTM; rr += 8 * RM::RPW) {
    const int64_t r = (int64_t)blockIdx.x * kTM + rr;
    const bool ok = r < rows;
    float xv[RM::NG][4];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < RM::NG; ++i) {
      if (ok)
        load4(x + r * C + 4 * (q + RM::L * i), xv[i]);
      else
        xv[i][0] = xv[i][1] = xv[i][2] = xv[i][3] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) ss += xv[i][e] * xv[i][e];
    }
#pragma unroll
    for (int o = RM::L / 2; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (!ok) continue;
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    if (BWD && q == 0) rn[r] = nrm;
#pragma unroll
    for (int i = 0; i < RM::NG; ++i) {
      const int col = 4 * (q + RM::L * i);
      float gv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) gv[e] = xv[i][e] / nrm * sc * gamma[col + e];
      store4<P>(g + r * C + col, lo, gv);
      if constexpr (BWD) {
        float dv[4], f[4];
        load4(dout + r * C + col, dv);
        bt::row_keep4(drop, bt::kSiteFFOut, (uint32_t)r, col >> 2, f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv[e] *= f[e];
          acc[i][e] += dv[e];
        }
        store4<P>(dy + r * C + col, lo, dv);
      }
    }
  }
  if constexpr (BWD) block_column_sums<C>(acc, red, db2p + blockIdx.x * (int64_t)C);
}

// After d_g = d_pre1 W1: dx = dout + (w - n (n . w)) / rn with w = d_g gamma
// sqrt(C) and n = x / rn, and the block's column sums of d_g n sqrt(C)
// (dgamma).
template <int C, typename T, typename X>
__global__ void __launch_bounds__(bt::kThreads)
    ff_post_kernel(const X* __restrict__ x, const float* __restrict__ gamma,
                   const T* __restrict__ dout, const float* __restrict__ rn,
                   const float* __restrict__ dg, X* __restrict__ dx, float* __restrict__ dgp,
                   int64_t rows) {
  using RM = RowMap<C>;
  __shared__ float red[8 * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane % RM::L;
  const float sc = sqrtf((float)C);
  float acc[RM::NG][4] = {};
  for (int rr = warp * RM::RPW + lane / RM::L; rr < kTM; rr += 8 * RM::RPW) {
    const int64_t r = (int64_t)blockIdx.x * kTM + rr;
    const bool ok = r < rows;
    const float nrm = ok ? rn[r] : 1.f;
    float n[RM::NG][4], d[RM::NG][4];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < RM::NG; ++i) {
      const int col = 4 * (q + RM::L * i);
      if (ok) {
        load4(x + r * C + col, n[i]);
        load4(dg + r * C + col, d[i]);
      } else {
        n[i][0] = n[i][1] = n[i][2] = n[i][3] = 0.f;
        d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        n[i][e] /= nrm;
        s += n[i][e] * d[i][e] * gamma[col + e] * sc;
        acc[i][e] += d[i][e] * n[i][e] * sc;
      }
    }
#pragma unroll
    for (int o = RM::L / 2; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (!ok) continue;
#pragma unroll
    for (int i = 0; i < RM::NG; ++i) {
      const int col = 4 * (q + RM::L * i);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t at = r * C + col + e;
        const float w = d[i][e] * gamma[col + e] * sc;
        dx[at] = bt::from_f<X>(bt::to_f(dout[at]) + (w - n[i][e] * s) / nrm);
      }
    }
  }
  block_column_sums<C>(acc, red, dgp + blockIdx.x * (int64_t)C);
}

// Depth slices of the forward's output product h1d W2^T (depth M): one
// while its output tiles (C / BN of them across, rows / 128 down) give
// about two blocks per SM, else enough slices for that, each at least 256
// deep. A slice writes a float32 partial that ff_out_sum_kernel adds in a
// fixed order (at 768 rows of C 512 the 24 tiles take 8 slices).
inline int out_splits(int64_t rows, int C, int M) {
  const int64_t tiles = (C + product_n(C) - 1) / product_n(C) * ((rows + kTM - 1) / kTM);
  const int64_t want = (2 * kCardSMs + tiles - 1) / tiles, most = M / 256 > 1 ? M / 256 : 1;
  return (int)(want < most ? want : most);
}

// The forward's scratch (on a null base: its size alone), bf16 operands of
// P parts: g (P rows C), h1d (P rows M), W1^T and W2^T (P M C each); with
// more than one output slice, their float32 partials (splits rows C).
struct FwdLayout {
  bf16 *g, *h1d, *w1t, *w2t;
  float* part;
  int splits;
  size_t bytes;

  FwdLayout(void* base, int P, int64_t rows, int C, int M) : splits(out_splits(rows, C, M)) {
    Carver c(base);
    g = c.take<bf16>(P * rows * C);
    h1d = c.take<bf16>(P * rows * M);
    w1t = c.take<bf16>(P * M * C);
    w2t = c.take<bf16>(P * M * C);
    part = c.take<float>(splits > 1 ? splits * rows * C : 0);
    bytes = c.bytes;
  }
};

// The forward's weight operands W1^T and W2^T as two jobs of a conversion
// launch (the caller may add its own jobs and launches it).
inline void fwd_operands(ConvJobs& conv, const FwdLayout& s, const void* w1, const void* w2,
                         int C, int M) {
  conv.add(w1, s.w1t, M, C, 1);
  conv.add(w2, s.w2t, C, M, 1);
}

// The forward's launches after the weight operands: the row pass, the hidden
// product and the output product, on rows x of type X, operands of P parts.
template <int C, typename T, typename X, int P>
cudaError_t fwd_rows_launch(const FwdLayout& s, const X* x, const float* gamma, const float* b1,
                            const float* b2, T* out, int64_t rows, int M, bt::Dropout drop,
                            cudaStream_t stream) {
  constexpr int BN = product_n(C);
  const int64_t rlo = rows * C, hlo = rows * M, wlo = (int64_t)M * C;
  const unsigned tiles = (unsigned)((rows + kTM - 1) / kTM);
  cudaError_t err;

  ff_pre_kernel<C, T, X, false, P><<<tiles, bt::kThreads, 0, stream>>>(
      x, gamma, nullptr, nullptr, s.g, nullptr, rlo, nullptr, rows, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto hidden = ff_hidden_kernel<P, false>;
  const size_t smem = product_smem<false, kHidN, P>();
  if ((err = bt::allow_smem(hidden, smem)) != cudaSuccess) return err;
  const Operand g{s.g, C, rlo}, w1t{s.w1t, M, wlo};
  hidden<<<dim3((unsigned)(M / kHidN), tiles), bt::kThreads, smem, stream>>>(
      g, w1t, g, w1t, b1, nullptr, s.h1d, hlo, nullptr, rows, M, C, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const Operand h1d{s.h1d, M, hlo}, w2t{s.w2t, C, wlo};
  const unsigned ntiles = (unsigned)((C + BN - 1) / BN);
  const size_t smem_out = product_smem<false, BN, P>();
  if (s.splits == 1) {
    auto outk = ff_out_kernel<BN, T, X, P>;
    if ((err = bt::allow_smem(outk, smem_out)) != cudaSuccess) return err;
    outk<<<dim3(ntiles, tiles), bt::kThreads, smem_out, stream>>>(h1d, w2t, x, b2, out, rows, C,
                                                                   M, drop);
    return cudaGetLastError();
  }
  // too few output tiles to fill the card: the depth in slices, then their sum
  auto pk = ff_product_kernel<false, BN, P>;
  if ((err = bt::allow_smem(pk, smem_out)) != cudaSuccess) return err;
  const int64_t k_per = ((M + s.splits - 1) / s.splits + kTK - 1) / kTK * kTK;
  pk<<<dim3(ntiles, tiles, (unsigned)s.splits), bt::kThreads, smem_out, stream>>>(
      h1d, w2t, s.part, C, rlo, 0, rows, C, M, k_per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t quads = rlo / 4;
  const unsigned sum_blocks =
      (unsigned)std::min<int64_t>((quads + bt::kThreads - 1) / bt::kThreads, kCardSMs * 16);
  ff_out_sum_kernel<T, X><<<sum_blocks, bt::kThreads, 0, stream>>>(s.part, s.splits, x, b2, out,
                                                                  rows, C, drop);
  return cudaGetLastError();
}

// The backward's scratch, section by section in this order (on a null base:
// its size alone): bf16 operands (P parts) g, d_y (rows C each), d_pre1,
// h1d (rows M each) and W1^T (M C); in float32 only W1 and W2 (P M C each;
// bf16 weights are their own operands); float32 row norms (rows), d_g
// (rows C), db2 and dgamma partials (tiles C each), db1 partials (tiles M),
// dW1 and dW2 partials (groups M C each). The first four sections come
// first: B7 reuses their space once the backward's launches are done.
struct BwdLayout {
  bf16 *g, *dy, *dp, *h1d, *w1t, *w1, *w2;
  float *rn, *dg, *db2p, *dgp, *db1p, *dw1p, *dw2p;
  int64_t tiles, groups;
  size_t bytes;

  BwdLayout(void* base, int P, int64_t rows, int C, int M, int64_t groups_)
      : tiles((rows + kTM - 1) / kTM), groups(groups_) {
    const int64_t S = P > 1 ? P : 0;
    Carver c(base);
    g = c.take<bf16>(P * rows * C);
    dy = c.take<bf16>(P * rows * C);
    dp = c.take<bf16>(P * rows * M);
    h1d = c.take<bf16>(P * rows * M);
    w1t = c.take<bf16>(P * M * C);
    w1 = c.take<bf16>(S * M * C);
    w2 = c.take<bf16>(S * M * C);
    rn = c.take<float>(rows);
    dg = c.take<float>(rows * C);
    db2p = c.take<float>(tiles * C);
    dgp = c.take<float>(tiles * C);
    db1p = c.take<float>(tiles * M);
    dw1p = c.take<float>(groups * M * C);
    dw2p = c.take<float>(groups * M * C);
    bytes = c.bytes;
  }
};

// d_g = d_pre1 W1 and the weight-gradient products, for a tile width BN.
template <int BN, int P>
cudaError_t bwd_products(const BwdLayout& s, Operand w1, int64_t rows, int C, int M,
                         int64_t group_rows, cudaStream_t stream) {
  const int64_t rlo = rows * C, hlo = rows * M, wlo = (int64_t)M * C;
  const unsigned ntiles = (unsigned)((C + BN - 1) / BN), rtiles = (unsigned)s.tiles;
  cudaError_t err;
  auto dg_kernel = ff_product_kernel<false, BN, P>;
  const size_t smem1 = product_smem<false, BN, P>();
  if ((err = bt::allow_smem(dg_kernel, smem1)) != cudaSuccess) return err;
  dg_kernel<<<dim3(ntiles, rtiles, 1), bt::kThreads, smem1, stream>>>(
      Operand{s.dp, M, hlo}, w1, s.dg, C, 0, 0, rows, C, M, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto wg_kernel = ff_product_kernel<true, BN, P>;
  const size_t smem2 = product_smem<true, BN, P>();
  if ((err = bt::allow_smem(wg_kernel, smem2)) != cudaSuccess) return err;
  const dim3 grid(ntiles, (unsigned)((M + kTM - 1) / kTM), (unsigned)s.groups);
  // dW1[j][c] = sum_r d_pre1[r][j] g[r][c]
  wg_kernel<<<grid, bt::kThreads, smem2, stream>>>(Operand{s.dp, M, hlo}, Operand{s.g, C, rlo},
                                                    s.dw1p, C, wlo, 0, M, C, rows, group_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dW2[c][j] = sum_r h1d[r][j] d_y[r][c], stored transposed
  wg_kernel<<<grid, bt::kThreads, smem2, stream>>>(Operand{s.h1d, M, hlo}, Operand{s.dy, C, rlo},
                                                    s.dw2p, M, wlo, 1, M, C, rows, group_rows);
  return cudaGetLastError();
}

// The backward's launches up to its sums: dx, and the partials of dgamma,
// dW1, db1, dW2 and db2 in the layout `s` (bwd_sums adds their jobs);
// operands of P parts (s laid out for P).
template <int C, typename T, typename X, int P>
cudaError_t bwd_launch(const BwdLayout& s, const X* x, const float* gamma, const T* w1,
                       const float* b1, const T* w2, const T* dout, X* dx, int64_t rows, int M,
                       int64_t group_rows, bt::Dropout drop, cudaStream_t stream) {
  const int64_t rlo = rows * C, hlo = rows * M, wlo = (int64_t)M * C;
  const unsigned tiles = (unsigned)s.tiles;
  cudaError_t err;

  ConvJobs conv;
  conv.add(w1, s.w1t, M, C, 1);
  if (P > 1) {
    conv.add(w1, s.w1, M, C, 0);
    conv.add(w2, s.w2, C, M, 0);
  }
  if ((err = convert<T, P>(conv, stream)) != cudaSuccess) return err;
  const bf16* w1s = P > 1 ? s.w1 : (const bf16*)w1;
  const bf16* w2s = P > 1 ? s.w2 : (const bf16*)w2;

  ff_pre_kernel<C, T, X, true, P><<<tiles, bt::kThreads, 0, stream>>>(
      x, gamma, dout, s.rn, s.g, s.dy, rlo, s.db2p, rows, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto hidden = ff_hidden_kernel<P, true>;
  const size_t smem = product_smem<false, kHidN, P>();
  if ((err = bt::allow_smem(hidden, smem)) != cudaSuccess) return err;
  hidden<<<dim3((unsigned)(M / kHidN), tiles), bt::kThreads, smem, stream>>>(
      Operand{s.g, C, rlo}, Operand{s.w1t, M, wlo}, Operand{s.dy, C, rlo}, Operand{w2s, M, wlo},
      b1, s.dp, s.h1d, hlo, s.db1p, rows, M, C, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const Operand w1_op{w1s, C, wlo};
  err = product_n(C) == 64 ? bwd_products<64, P>(s, w1_op, rows, C, M, group_rows, stream)
                           : bwd_products<128, P>(s, w1_op, rows, C, M, group_rows, stream);
  if (err != cudaSuccess) return err;
  ff_post_kernel<C, T, X><<<tiles, bt::kThreads, 0, stream>>>(x, gamma, dout, s.rn, s.dg, dx,
                                                              s.dgp, rows);
  return cudaGetLastError();
}

// The backward's five sums (db2, dgamma, db1, dW1, dW2) as jobs at .. at + 4
// of a sums launch.
template <int J>
void bwd_sums(const BwdLayout& s, int C, int M, float* dgamma, float* dw1, float* db1,
              float* dw2, float* db2, SumJobs<J>& sums, int at) {
  const int64_t wlo = (int64_t)M * C;
  sums.set(at, s.db2p, db2, s.tiles, C);
  sums.set(at + 1, s.dgp, dgamma, s.tiles, C);
  sums.set(at + 2, s.db1p, db1, s.tiles, M);
  sums.set(at + 3, s.dw1p, dw1, s.groups, wlo);
  sums.set(at + 4, s.dw2p, dw2, s.groups, wlo);
}

}  // namespace ff
}  // namespace
