// Feed-forward residual for training, forward and backward:
//   out = x + drop_out(W2 drop_hid(gelu(W1 g + b1)) + b2),  g = rmsnorm(x) * gamma,
// with the dropout masks drawn from Philox (philox.cuh) by element
// coordinates, so the backward regenerates the forward's masks.
//
// Replaces beat_this_tpu/ops/fused_ff.py:_ff_train_kernel (forward, reached
// through _fused_ff_train) and :_ff_train_bwd_kernel (backward, through
// _fused_ff_train_bwd).
//
// The forward (B8) streams the hidden layer 64 units at a time through
// bt::ff_tail (SIMT float32 FMAs), so it never reaches device memory.
//
// The backward (B9) does the TPU kernel's five products, once each, on the
// tensor cores (mma.sync m16n8k16, bf16 operands, float32 accumulators,
// mma.cuh). The TPU kernel sums the weight gradients across its sequential
// grid; here blocks run in parallel, so the backward writes its hidden-width
// operands to scratch and takes the weight gradients as products over the
// rows:
//   1. weights:  W1, W1^T and W2 as bf16 operands;
//   2. pre:      per 128 rows, the row norms, g = round_T(rmsnorm(x) gamma)
//                and d_y = round_T(dout * output mask) as bf16 operands, and
//                the tile's column sums of the unrounded d_y (db2);
//   3. hidden:   per (128 rows, 64 hidden units), pre1 = g W1^T and d_h1 =
//                d_y W2 on one tile; its epilogue draws the hidden mask once
//                and writes h1d = round_T(gelu(pre1 + b1) f) and d_pre1 =
//                round_T(d_h1 f gelu'(pre1 + b1)) to scratch, with the tile's
//                column sums of the unrounded d_pre1 (db1);
//   4. d_g = d_pre1 W1 (float32, scratch);
//   5. post:     per 128 rows, dx = dout + rmsnorm'(d_g) and the tile's
//                column sums for dgamma;
//   6. dW1 = d_pre1^T g and dW2 = d_y^T h1d, over groups of rows (one
//      float32 partial per group);
//   7. the per-tile and per-group partials summed in a fixed order, in one
//      launch (column_sums_kernel), so two runs give the same bits (no
//      float atomics).
// float32 runs every product as three bf16 products of split operands (a =
// a_hi + a_lo, both bf16: a_hi b_hi + a_hi b_lo + a_lo b_hi), about 16
// significant bits against plain TF32's 11; the scratch then holds both
// parts of each operand. Scratch at C 512 and 12000 rows: 0.20 GB in bf16,
// 0.33 GB in float32; at the frontend's widths up to 0.33 / 0.58 GB
// (Layout; the wrapper asks bt_ff_train_bwd_scratch for the size).
//
// Bound on the H100: arithmetic at C 512 (five products of 2 rows C 4C
// FLOPs against about 4 C values of each row read or written); at the
// frontend's C 32-128 the bytes of the scratch operands bound it.
#include <type_traits>

#include "tc_product.cuh"

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

// -- backward ------------------------------------------------------------------

using namespace mm;

constexpr int kHidN = 64;   // hidden units per block of the hidden pass

// out (+ blockIdx.z * out_step) = A B over the depth slice [z k_per,
// min((z + 1) k_per, k_end)) of z = blockIdx.z, for A (m_end x K) and B
// (K x n_end); element (m, n) at out[m * ldo + n], or with trans_out at
// out[n * ldo + m].
template <bool AM, int BN, bool SPLIT>
__global__ void __launch_bounds__(bt::kThreads)
    ff_product_kernel(Operand A, Operand B, float* __restrict__ out, int64_t ldo,
                      int64_t out_step, int trans_out, int64_t m_end, int n_end, int64_t k_end,
                      int64_t k_per) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int64_t m0 = (int64_t)blockIdx.y * kTM, k0 = (int64_t)blockIdx.z * k_per;
  const int n0 = blockIdx.x * BN;
  float acc[2][BN / 16][4];
  product<AM, BN, SPLIT>(acc, A, B, m0, n0, k0, min(k0 + k_per, k_end), m_end, n_end,
                         reinterpret_cast<bf16*>(smem_b));
  store_product<BN>(acc, out + blockIdx.z * out_step, ldo, trans_out, m0, n0, m_end, n_end);
}

// The hidden pass over rows [m0, m0 + kTM) and hidden units [n0, n0 +
// kHidN): pre1 = g W1^T + b1 and d_h1 = d_y W2 on the tensor cores, then
// h1d = round_T(gelu(pre1) f) and d_pre1 = d_h1 f gelu'(pre1) for the hidden
// keep factors f; writes h1d and round_T(d_pre1) (M columns, bf16 parts
// `lo` apart) and the tile's column sums of the unrounded d_pre1 (db1).
template <bool SPLIT>
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
  product<false, kHidN, SPLIT>(pre, G, W1t, m0, n0, 0, C, rows, M, smem);
  product<false, kHidN, SPLIT>(dh, DY, W2, m0, n0, 0, C, rows, M, smem);

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
          dv[e] = r < rows ? dh[mi][j][2 * h + e] * f[h][e] * bt::gelu_grad(p) : 0.f;
          colsum[j][e] += dv[e];
        }
        if (r < rows) {
          store2<SPLIT>(h1d + r * M + col, lo, hv[0], hv[1]);
          store2<SPLIT>(dp + r * M + col, lo, dv[0], dv[1]);
        }
      }
    }
  // column sums: over the 8 row groups of a warp, then over the 4 warps of a
  // column half, in a fixed order
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

// Row passes: a block covers kTM rows with 8 warps. A row takes L = min(32,
// C / 4) lanes, each over NG = C / (4 L) groups of 4 columns (q + L i for
// lane q of the row); a warp covers 32 / L rows at once.
template <int C> struct RowMap {
  static constexpr int L = C / 4 < 32 ? C / 4 : 32, NG = C / (4 * L), RPW = 32 / L;
};

template <typename T> __device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = bt::to_f(p[e]);
}

// Each lane's per-column sums acc (its NG groups of 4 columns) summed over
// the rows of the block into part[0 .. C), in a fixed order: over the lanes
// of one column group in a warp, then over the 8 warps. red: 8 C floats of
// shared memory.
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
}

// Before the products: each row's clamped norm rn, g = round_T(rmsnorm(x)
// gamma) and d_y = round_T(dout * output mask) as bf16 operands (parts `lo`
// apart), and the block's column sums of the unrounded d_y (db2).
template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    ff_bwd_pre_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const T* __restrict__ dout, float* __restrict__ rn, bf16* __restrict__ g,
                      bf16* __restrict__ dy, int64_t lo, float* __restrict__ db2p, int64_t rows,
                      bt::Dropout drop) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  using RM = RowMap<C>;
  __shared__ float red[8 * C];
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
    if (q == 0) rn[r] = nrm;
#pragma unroll
    for (int i = 0; i < RM::NG; ++i) {
      const int col = 4 * (q + RM::L * i);
      float gv[4], dv[4], f[4];
      load4(dout + r * C + col, dv);
      bt::keep4(drop, bt::kSiteFFOut, 0, 0, (uint32_t)r, col >> 2, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gv[e] = xv[i][e] / nrm * sc * gamma[col + e];
        dv[e] *= f[e];
        acc[i][e] += dv[e];
      }
      store4<SPLIT>(g + r * C + col, lo, gv);
      store4<SPLIT>(dy + r * C + col, lo, dv);
    }
  }
  block_column_sums<C>(acc, red, db2p + blockIdx.x * (int64_t)C);
}

// After d_g = d_pre1 W1: dx = dout + (w - n (n . w)) / rn with w = d_g gamma
// sqrt(C) and n = x / rn, and the block's column sums of d_g n sqrt(C)
// (dgamma).
template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    ff_bwd_post_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const T* __restrict__ dout, const float* __restrict__ rn,
                       const float* __restrict__ dg, T* __restrict__ dx, float* __restrict__ dgp,
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
        dx[at] = bt::from_f<T>(bt::to_f(dout[at]) + (w - n[i][e] * s) / nrm);
      }
    }
  }
  block_column_sums<C>(acc, red, dgp + blockIdx.x * (int64_t)C);
}

// The weights as bf16 operands (parts `lo` apart): w1 (M, C) as it is and
// transposed to (C, M), w2 (C, M) as it is.
template <typename T>
__global__ void __launch_bounds__(bt::kThreads)
    ff_bwd_weights_kernel(const T* __restrict__ w1, const T* __restrict__ w2,
                          bf16* __restrict__ w1s, bf16* __restrict__ w1t, bf16* __restrict__ w2s,
                          int64_t lo, int M, int C) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  const int64_t i = (int64_t)blockIdx.x * bt::kThreads + threadIdx.x;
  if (i >= (int64_t)M * C) return;
  const int64_t j = i / C, c = i % C;
  const float a = bt::to_f(w1[i]), b = bt::to_f(w2[i]);
  const bf16 ah = __float2bfloat16(a), bh = __float2bfloat16(b);
  w1s[i] = ah;
  w1t[c * M + j] = ah;
  w2s[i] = bh;
  if constexpr (SPLIT) {
    const bf16 al = __float2bfloat16(a - __bfloat162float(ah));
    w1s[lo + i] = al;
    w1t[lo + c * M + j] = al;
    w2s[lo + i] = __float2bfloat16(b - __bfloat162float(bh));
  }
}

// The backward's five fixed-order sums (db2, dgamma, db1, dW1, dW2), in one
// launch.
__global__ void __launch_bounds__(bt::kThreads) column_sums_kernel(SumJobs<5> s) {
  column_sums(s);
}

// The backward's scratch, section by section in this order, each starting
// on a multiple of kAlign bytes (built on a null base, it gives the size
// alone: bt_ff_train_bwd_scratch):
// bf16 operands (P = 2 parts in float32, 1 in bf16) g, d_y (P rows C each),
// d_pre1, h1d (P rows M), W1, W1^T, W2 (P M C); float32 row norms (rows),
// d_g (rows C), db2 and dgamma partials (tiles C each), db1 partials (tiles
// M), dW1 and dW2 partials (groups M C each).
struct Layout {
  bf16 *g, *dy, *dp, *h1d, *w1, *w1t, *w2;
  float *rn, *dg, *db2p, *dgp, *db1p, *dw1p, *dw2p;
  size_t bytes;

  Layout(void* base, bool split, int64_t rows, int C, int M, int groups) {
    const int64_t P = split ? 2 : 1, tiles = (rows + kTM - 1) / kTM;
    Carver c(base);
    g = c.take<bf16>(P * rows * C);
    dy = c.take<bf16>(P * rows * C);
    dp = c.take<bf16>(P * rows * M);
    h1d = c.take<bf16>(P * rows * M);
    w1 = c.take<bf16>(P * M * C);
    w1t = c.take<bf16>(P * M * C);
    w2 = c.take<bf16>(P * M * C);
    rn = c.take<float>(rows);
    dg = c.take<float>(rows * C);
    db2p = c.take<float>(tiles * C);
    dgp = c.take<float>(tiles * C);
    db1p = c.take<float>(tiles * M);
    dw1p = c.take<float>((int64_t)groups * M * C);
    dw2p = c.take<float>((int64_t)groups * M * C);
    bytes = c.bytes;
  }
};

// d_g = d_pre1 W1 and the weight-gradient products, for a tile width BN.
template <int BN, bool SPLIT>
cudaError_t launch_products(const Layout& s, int64_t rows, int C, int M, int groups,
                            int64_t group_rows, cudaStream_t stream) {
  const int64_t rlo = rows * C, hlo = rows * M, wlo = (int64_t)M * C;
  const unsigned ntiles = (unsigned)((C + BN - 1) / BN), rtiles = (unsigned)((rows + kTM - 1) / kTM);
  cudaError_t err;
  auto dg_kernel = ff_product_kernel<false, BN, SPLIT>;
  const size_t smem1 = product_smem<false, BN, SPLIT>();
  if ((err = bt::allow_smem(dg_kernel, smem1)) != cudaSuccess) return err;
  dg_kernel<<<dim3(ntiles, rtiles, 1), bt::kThreads, smem1, stream>>>(
      Operand{s.dp, M, hlo}, Operand{s.w1, C, wlo}, s.dg, C, 0, 0, rows, C, M, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto wg_kernel = ff_product_kernel<true, BN, SPLIT>;
  const size_t smem2 = product_smem<true, BN, SPLIT>();
  if ((err = bt::allow_smem(wg_kernel, smem2)) != cudaSuccess) return err;
  const dim3 grid(ntiles, (unsigned)((M + kTM - 1) / kTM), (unsigned)groups);
  // dW1[j][c] = sum_r d_pre1[r][j] g[r][c]
  wg_kernel<<<grid, bt::kThreads, smem2, stream>>>(Operand{s.dp, M, hlo}, Operand{s.g, C, rlo},
                                                    s.dw1p, C, wlo, 0, M, C, rows, group_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dW2[c][j] = sum_r h1d[r][j] d_y[r][c], stored transposed
  wg_kernel<<<grid, bt::kThreads, smem2, stream>>>(Operand{s.h1d, M, hlo}, Operand{s.dy, C, rlo},
                                                    s.dw2p, M, wlo, 1, M, C, rows, group_rows);
  return cudaGetLastError();
}

template <int C, typename T>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* w1, const void* b1,
                       const void* w2, const void* dout, void* dx, void* dgamma, void* dw1,
                       void* db1, void* dw2, void* db2, void* scratch, int64_t scratch_bytes,
                       int64_t rows, int M, int64_t group_rows, bt::Dropout drop,
                       cudaStream_t stream) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  const int groups = (int)row_groups(rows, group_rows);
  const Layout s(scratch, SPLIT, rows, C, M, groups);
  if ((int64_t)s.bytes > scratch_bytes) return cudaErrorInvalidValue;
  const int64_t tiles = (rows + kTM - 1) / kTM, rlo = rows * C, hlo = rows * M;
  const int64_t wlo = (int64_t)M * C;
  cudaError_t err;

  ff_bwd_weights_kernel<T><<<(unsigned)((wlo + bt::kThreads - 1) / bt::kThreads), bt::kThreads,
                             0, stream>>>((const T*)w1, (const T*)w2, s.w1, s.w1t, s.w2, wlo, M,
                                          C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ff_bwd_pre_kernel<C, T><<<(unsigned)tiles, bt::kThreads, 0, stream>>>(
      (const T*)x, (const float*)gamma, (const T*)dout, s.rn, s.g, s.dy, rlo, s.db2p, rows, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto hidden = ff_hidden_kernel<SPLIT>;
  const size_t smem = product_smem<false, kHidN, SPLIT>();
  if ((err = bt::allow_smem(hidden, smem)) != cudaSuccess) return err;
  hidden<<<dim3((unsigned)(M / kHidN), (unsigned)tiles), bt::kThreads, smem, stream>>>(
      Operand{s.g, C, rlo}, Operand{s.w1t, M, wlo}, Operand{s.dy, C, rlo}, Operand{s.w2, M, wlo},
      (const float*)b1, s.dp, s.h1d, hlo, s.db1p, rows, M, C, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = product_n(C) == 64
            ? launch_products<64, SPLIT>(s, rows, C, M, groups, group_rows, stream)
            : launch_products<128, SPLIT>(s, rows, C, M, groups, group_rows, stream);
  if (err != cudaSuccess) return err;
  ff_bwd_post_kernel<C, T><<<(unsigned)tiles, bt::kThreads, 0, stream>>>(
      (const T*)x, (const float*)gamma, (const T*)dout, s.rn, s.dg, (T*)dx, s.dgp, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  SumJobs<5> sums{{s.db2p, s.dgp, s.db1p, s.dw1p, s.dw2p},
                  {(float*)db2, (float*)dgamma, (float*)db1, (float*)dw1, (float*)dw2},
                  {(int)tiles, (int)tiles, (int)tiles, groups, groups},
                  {C, C, M, wlo, wlo},
                  {0}};
  column_sums_kernel<<<sums.finish(), bt::kThreads, 0, stream>>>(sums);
  return cudaGetLastError();
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
                         void* db1, void* dw2, void* db2, void* scratch, int64_t scratch_bytes,
                         int64_t rows, int M, int64_t group_rows, bt::Dropout drop,
                         cudaStream_t s) {
#define BT_CALL(CC)                                                                         \
  launch_bwd<CC, T>(x, gamma, w1, b1, w2, dout, dx, dgamma, dw1, db1, dw2, db2, scratch,     \
                    scratch_bytes, rows, M, group_rows, drop, s)
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

// Output tiles of one weight-gradient product of bt_ff_train_bwd ((M, C) in
// blocks of kTM x product_n(C)), the blocks of each row group.
extern "C" int bt_ff_wgrad_tiles(int C, int M, int* tiles) {
  if (C <= 0 || M % kHidN) return (int)cudaErrorInvalidValue;
  *tiles = (M + kTM - 1) / kTM * ((C + product_n(C) - 1) / product_n(C));
  return 0;
}

// Bytes of bt_ff_train_bwd's scratch for these arguments, in *bytes.
extern "C" int bt_ff_train_bwd_scratch(int dtype, int C, long long rows, int M,
                                       long long group_rows, long long* bytes) {
  if ((dtype != 0 && dtype != 1) || rows < 0 || group_rows < 1)
    return (int)cudaErrorInvalidValue;
  *bytes = (long long)Layout(nullptr, dtype == 0, rows, C, M, (int)row_groups(rows, group_rows))
               .bytes;
  return 0;
}

// As bt_ff_train_fwd, plus dout and dx (rows, C) in the dtype and float32
// gradients dgamma (C), dw1 (M, C), db1 (M), dw2 (C, M), db2 (C). scratch:
// scratch_bytes bytes, at least bt_ff_train_bwd_scratch's; the weight-gradient
// products take the rows in groups of group_rows >= 1 (ops/fused_ff.py:
// ff_wgrad_split).
extern "C" int bt_ff_train_bwd(int dtype, int C, const void* x, const void* gamma,
                               const void* w1, const void* b1, const void* w2, const void* dout,
                               void* dx, void* dgamma, void* dw1, void* db1, void* dw2, void* db2,
                               void* scratch, long long scratch_bytes, long long rows, int M,
                               long long group_rows, unsigned seed, unsigned salt, unsigned thr,
                               float scale, int on, void* stream) {
  if (rows <= 0) return 0;
  if (M % kHidN || group_rows < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? dispatch_bwd<float>(C, x, gamma, w1, b1, w2, dout, dx, dgamma, dw1, db1, dw2,
                                         db2, scratch, scratch_bytes, rows, M, group_rows, d, s)
               : dtype == 1
                   ? dispatch_bwd<__nv_bfloat16>(C, x, gamma, w1, b1, w2, dout, dx, dgamma, dw1,
                                                 db1, dw2, db2, scratch, scratch_bytes, rows, M,
                                                 group_rows, d, s)
                   : cudaErrorInvalidValue);
}
