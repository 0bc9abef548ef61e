// Backward of the fused frequency-axis block in training (B7): dx and the
// ten parameter gradients (dgamma_attn, dW_qkv, dW_gates, db_gates, dW_out,
// dgamma_ff, dW1, db1, dW2, db2) of
//   x2  = x + drop(W_out (gate * attention)),
//   out = x2 + drop(W2 drop(gelu(W1 rmsnorm(x2) + b1)) + b2),
// with attention within each item of F consecutive rows (F <= 32 keys) and
// the four dropout masks regenerated from Philox by coordinates: the
// probabilities at (item, head, query, key), the other three sites at (row
// of the (items * F, C) view, column).
//
// Replaces beat_this_tpu/ops/fused_freq.py:_fused_freq_bwd_kernel (reached
// through _fused_freq_bwd). On the TPU one kernel recomputes the block per
// row tile and accumulates every weight gradient across its sequential grid.
// Here blocks run in parallel, so the block is decomposed into launches with
// O(rows C) intermediates in device memory. Every projection and weight
// gradient runs on the staged tensor-core product of tc_product.cuh
// (mma.sync m16n8k16, bf16 operands, float32 accumulators; float32 as six
// bf16 products of operands split in three parts, float32's 24 bits: with
// two parts, as B5 and B9 take them, the gate bias's gradient, a sum over
// rows that cancels, missed 1e-4 of the plain version); so does the
// attention over F <= 32 keys, on the packed score tile of small_tile.cuh
// (freq_core.cu, compiled apart).
//
//   recompute the attention half from x (x is the only saved activation):
//   1. operands: W_qkv^T and W_out^T (float32: also W_qkv, W_out split);
//   2. rows:     per 128 rows, the norm, g = round_T(rmsnorm(x) gamma) as an
//                operand and the gates sigmoid(g W_g + b_g) (float32 g and
//                W_g, as the forward);
//   3. qkv:      g W_qkv^T, whose epilogue rounds q, k, v and applies RoPE to
//                q and k at position row % F (rounded again);
//   4. attn:     per (item, head) (freq_core.cu), p = exp2(s - m) with m
//                the row maximum, l and o = round_T(round_T(p f) v / l);
//                writes o and go = round_T(o gate) as an operand;
//   5. out:      x2 = x + (go W_out^T) times the output mask, in float32;
//   the feed-forward half, B9's launches on x2 (ff_train.cuh, float32 rows):
//   6. d_x2 and the partials of dgamma_ff, dW1, db1, dW2, db2;
//   the attention branch's backward:
//   7. d_attn = round_T(d_x2 * output mask) as an operand;
//   8. d_og = d_attn W_out, whose epilogue writes d_o = round_T(d_og gate)
//      and the gate logits' cotangent d_z = (d_og . o) sig (1 - sig) per head;
//   9. attn bwd: per (item, head) (freq_core.cu), S and p recomputed, ds
//      and dq query-major, then dk and dv key-major; d_q, d_k (inverse
//      RoPE, times 32^-0.5) and d_v as an operand;
//   10. d_g = [d_q | d_k | d_v] W_qkv (float32);
//   11. post:    per 128 rows, + round_T(d_z) W_g and the RMSNorm backward
//       for dx = d_x2 + rmsnorm'(d_g), the partials of dgamma_attn, dW_g and
//       db_g;
//   12. dW_qkv = d_qkv^T g and dW_out = d_attn^T go over groups of rows, in
//       one launch;
//   13. every partial (B9's five and these five) summed in a fixed order in
//       one launch: two runs give the same bits (no float atomics).
// The scratch layout lives only here (Layout); the wrapper asks
// bt_freq_train_bwd_scratch for its size. x2 is float32 in both dtypes, as
// the plain version keeps x + branch unrounded into the FF.
//
// Bound on the H100: the projections and weight gradients (3 (8 C^2 + 8 C M)
// FLOPs a row) against C values of x, dout and dx a row; at C 32 the bytes
// of the scratch operands bound it. bfloat16 values are rounded where the
// TPU kernel rounds them (g, q/k/v, the dropped probabilities, the attention
// output and the gated output; the cotangents of the out projection, the PV
// product, the scores, the gate logits and q/k/v before their products).
#include <algorithm>

#include "ff_train.cuh"
#include "freq_core.cuh"

namespace {

using mm::kTM;
using mm::Operand;
using bf16 = __nv_bfloat16;

constexpr int kHD = bt::kHeadDim;  // 32

// Parts of an operand: float32's own precision (mm::full_parts), as the
// gradients reach the gate bias through four products and the sums over
// rows cancel (two parts missed the plain version by 1e-4: PERF.md,
// Findings, PR 9).
template <typename T> constexpr int kParts = mm::full_parts<T>();

// -- row passes ------------------------------------------------------------------

// Per 128 rows: each row's clamped norm rn, g = round_T(rmsnorm(x) gamma) as
// an operand (parts `lo` apart) and the unrounded gates sig = sigmoid(g W_g
// + b_g) per head, from the rounded g and float32 W_g.
template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    freq_rows_kernel(const T* __restrict__ x, const float* __restrict__ agamma,
                     const float* __restrict__ wg, const float* __restrict__ gb,
                     float* __restrict__ rn, bf16* __restrict__ g, int64_t lo,
                     float* __restrict__ sig, int64_t rows) {
  constexpr int P = kParts<T>;
  constexpr int H = C / kHD;
  using RM = mm::RowMap<C>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane % RM::L;
  const float sc = sqrtf((float)C);
  for (int rr = warp * RM::RPW + lane / RM::L; rr < kTM; rr += 8 * RM::RPW) {
    const int64_t r = (int64_t)blockIdx.x * kTM + rr;
    const bool ok = r < rows;
    float xv[RM::NG][4];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < RM::NG; ++i) {
      if (ok)
        mm::load4(x + r * C + 4 * (q + RM::L * i), xv[i]);
      else
        xv[i][0] = xv[i][1] = xv[i][2] = xv[i][3] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) ss += xv[i][e] * xv[i][e];
    }
#pragma unroll
    for (int o = RM::L / 2; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    float z[H] = {};
#pragma unroll
    for (int i = 0; i < RM::NG; ++i) {
      const int col = 4 * (q + RM::L * i);
      float gv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gv[e] = xv[i][e] / nrm * sc * agamma[col + e];
#pragma unroll
        for (int h = 0; h < H; ++h) z[h] += bt::round_to<T>(gv[e]) * wg[h * C + col + e];
      }
      if (ok) mm::store4<P>(g + r * C + col, lo, gv);
    }
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int o = RM::L / 2; o; o >>= 1) z[h] += __shfl_xor_sync(0xffffffffu, z[h], o);
    if (ok && q == 0) {
      rn[r] = nrm;
#pragma unroll
      for (int h = 0; h < H; ++h) sig[r * H + h] = 1.f / (1.f + expf(-(z[h] + gb[h])));
    }
  }
}

// d_attn = round_T(d_x2 * output mask) as an operand, four columns a thread
// and step.
template <typename T>
__global__ void __launch_bounds__(bt::kThreads)
    freq_dattn_kernel(const float* __restrict__ dx2, bf16* __restrict__ da, int64_t lo,
                      int64_t rows, int C, bt::Dropout drop) {
  constexpr int P = kParts<T>;
  const int64_t quads = rows * C / 4;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < quads;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = e / (C / 4), at = 4 * e;
    const int c = (int)(at - r * C);
    float f[4], d[4];
    bt::row_keep4(drop, bt::kSiteAttnOut, (uint32_t)r, c >> 2, f);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = dx2[at + i] * f[i];
    mm::store4<P>(da + at, lo, d);
  }
}

// Per 128 rows: d_g (float32, from the product) + round_T(d_z) W_g, then dx
// = d_x2 + (w - n (n . w)) / rn with w = d_g gamma sqrt(C) and n = x / rn;
// the block's partials of dgamma (d_g n sqrt(C)), dW_g (round_T(d_z) g with
// g = round_T(n sqrt(C) gamma), as the rows pass rounds it) and db_g (d_z).
template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    freq_post_kernel(const T* __restrict__ x, const float* __restrict__ agamma,
                     const float* __restrict__ wg, const float* __restrict__ rn,
                     const float* __restrict__ dg, const float* __restrict__ dz,
                     const float* __restrict__ dx2, T* __restrict__ dx, float* __restrict__ dgap,
                     float* __restrict__ dwgp, float* __restrict__ dbgp, int64_t rows) {
  constexpr int H = C / kHD;
  using RM = mm::RowMap<C>;
  __shared__ float red[8 * C];
  __shared__ float bred[8][H];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane % RM::L;
  const float sc = sqrtf((float)C);
  float acc[RM::NG][4] = {}, accw[H][RM::NG][4] = {}, accb[H] = {};
  for (int rr = warp * RM::RPW + lane / RM::L; rr < kTM; rr += 8 * RM::RPW) {
    const int64_t r = (int64_t)blockIdx.x * kTM + rr;
    const bool ok = r < rows;
    const float nrm = ok ? rn[r] : 1.f;
    float dzv[H], dzr[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      dzv[h] = ok ? dz[r * H + h] : 0.f;
      dzr[h] = bt::round_to<T>(dzv[h]);
    }
    float n[RM::NG][4], d[RM::NG][4];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < RM::NG; ++i) {
      const int col = 4 * (q + RM::L * i);
      if (ok) {
        mm::load4(x + r * C + col, n[i]);
        mm::load4(dg + r * C + col, d[i]);
      } else {
        n[i][0] = n[i][1] = n[i][2] = n[i][3] = 0.f;
        d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int h = 0; h < H; ++h) d[i][e] += dzr[h] * wg[h * C + col + e];
        n[i][e] /= nrm;
        s += n[i][e] * d[i][e] * agamma[col + e] * sc;
        acc[i][e] += d[i][e] * n[i][e] * sc;
        const float gv = bt::round_to<T>(n[i][e] * sc * agamma[col + e]);
#pragma unroll
        for (int h = 0; h < H; ++h) accw[h][i][e] += dzr[h] * gv;
      }
    }
#pragma unroll
    for (int o = RM::L / 2; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (!ok) continue;
    if (q == 0)
#pragma unroll
      for (int h = 0; h < H; ++h) accb[h] += dzv[h];
#pragma unroll
    for (int i = 0; i < RM::NG; ++i) {
      const int col = 4 * (q + RM::L * i);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t at = r * C + col + e;
        const float w = d[i][e] * agamma[col + e] * sc;
        dx[at] = bt::from_f<T>(dx2[at] + (w - n[i][e] * s) / nrm);
      }
    }
  }
  const int64_t tile = blockIdx.x;
  ff::block_column_sums<C>(acc, red, dgap + tile * C);
#pragma unroll
  for (int h = 0; h < H; ++h) ff::block_column_sums<C>(accw[h], red, dwgp + (tile * H + h) * C);
  // db_g: over the warp's lanes, then over the 8 warps in order
#pragma unroll
  for (int h = 0; h < H; ++h) {
    float v = accb[h];
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) bred[warp][h] = v;
  }
  __syncthreads();
  if (threadIdx.x < H) {
    float v = 0.f;
    for (int w = 0; w < 8; ++w) v += bred[w][threadIdx.x];
    dbgp[tile * H + threadIdx.x] = v;
  }
}

// -- products with epilogues -------------------------------------------------

// q, k, v = g W_qkv^T (A: g, B: W_qkv^T, operands), rounded to T, with RoPE
// on q and k at position row % F, rounded again, into qkv (rows, 3C) of T.
template <int BN, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    freq_qkv_kernel(Operand A, Operand B, const float* __restrict__ cosv,
                    const float* __restrict__ sinv, T* __restrict__ qkv, int64_t rows, int C,
                    int F) {
  constexpr int P = kParts<T>;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int64_t m0 = (int64_t)blockIdx.y * kTM;
  const int n0 = blockIdx.x * BN;
  float acc[2][BN / 16][4];
  mm::product<false, BN, P>(acc, A, B, m0, n0, 0, C, rows, 3 * C,
                                reinterpret_cast<bf16*>(smem_b));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp & 3), wn = (BN / 2) * (warp >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t row = m0 + wm + 16 * mi + (lane >> 2) + 8 * hh;
        const int col = n0 + wn + 8 * j + 2 * (lane & 3);
        if (row >= rows || col >= 3 * C) continue;
        float a = bt::round_to<T>(acc[mi][j][2 * hh]), b = bt::round_to<T>(acc[mi][j][2 * hh + 1]);
        if (col < 2 * C) {  // the rotation pair (col, col + 1) of q or k
          const int at = (int)(row % F) * (kHD / 2) + (col % kHD) / 2;
          const float cs = cosv[at], sn = sinv[at];
          const float ra = bt::round_to<T>(a * cs - b * sn);
          const float rb = bt::round_to<T>(b * cs + a * sn);
          a = ra;
          b = rb;
        }
        qkv[row * 3 * C + col] = bt::from_f<T>(a);
        qkv[row * 3 * C + col + 1] = bt::from_f<T>(b);
      }
}

// x2 = x + (go W_out^T) times the output keep factors, in float32 (A: go,
// B: W_out^T, operands).
template <int BN, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    freq_out_kernel(Operand A, Operand B, const T* __restrict__ x, float* __restrict__ x2,
                    int64_t rows, int C, bt::Dropout drop) {
  constexpr int P = kParts<T>;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int64_t m0 = (int64_t)blockIdx.y * kTM;
  const int n0 = blockIdx.x * BN;
  float acc[2][BN / 16][4];
  mm::product<false, BN, P>(acc, A, B, m0, n0, 0, C, rows, C,
                                reinterpret_cast<bf16*>(smem_b));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp & 3), wn = (BN / 2) * (warp >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int64_t row = m0 + wm + 16 * mi + (lane >> 2);
      const int col8 = n0 + wn + 8 * j, col = col8 + 2 * (lane & 3);
      float f[2][2];
      mm::row_keep(drop, bt::kSiteAttnOut, row, col8, f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t r = row + 8 * hh;
        if (r >= rows || col >= C) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          x2[r * C + col + e] = bt::to_f(x[r * C + col + e]) + acc[mi][j][2 * hh + e] * f[hh][e];
      }
    }
}

// d_og = d_attn W_out (A: d_attn, B: W_out, operands), and from it per
// (row, head): d_o = round_T(d_og gate) into dO (rows, C) of T and d_z =
// (d_og . o) sig (1 - sig) with gate = round_T(sig) and o the rounded
// attention output. A warp's BN / 2 columns are whole heads.
template <int BN, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    freq_dog_kernel(Operand A, Operand B, const T* __restrict__ o, const float* __restrict__ sig,
                    T* __restrict__ dO, float* __restrict__ dz, int64_t rows, int C) {
  constexpr int P = kParts<T>;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int64_t m0 = (int64_t)blockIdx.y * kTM;
  const int n0 = blockIdx.x * BN;
  float acc[2][BN / 16][4];
  mm::product<false, BN, P>(acc, A, B, m0, n0, 0, C, rows, C,
                                reinterpret_cast<bf16*>(smem_b));
  const int H = C / kHD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wm = 32 * (warp & 3), wn = (BN / 2) * (warp >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t row = m0 + wm + 16 * mi + g + 8 * hh;
#pragma unroll
      for (int hw = 0; hw < BN / 64; ++hw) {
        const int c0 = n0 + wn + kHD * hw, head = c0 / kHD;
        const bool ok = row < rows && c0 < C;
        const float s = ok ? sig[row * H + head] : 0.f, gate = bt::round_to<T>(s);
        float zo = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int64_t at = row * C + c0 + 8 * jj + 2 * t;
          const float a0 = acc[mi][4 * hw + jj][2 * hh], a1 = acc[mi][4 * hw + jj][2 * hh + 1];
          if (ok) {
            zo += a0 * bt::to_f(o[at]) + a1 * bt::to_f(o[at + 1]);
            dO[at] = bt::from_f<T>(a0 * gate);
            dO[at + 1] = bt::from_f<T>(a1 * gate);
          }
        }
        zo += __shfl_xor_sync(0xffffffffu, zo, 1);
        zo += __shfl_xor_sync(0xffffffffu, zo, 2);
        if (ok && t == 0) dz[row * H + head] = zo * s * (1.f - s);
      }
    }
}

// The backward's products over the staged product's jobs (d_g: one job;
// dW_qkv and dW_out: two).
template <bool AM, int BN, int P>
__global__ void __launch_bounds__(bt::kThreads)
    freq_product_kernel(mm::ProductJob j0, mm::ProductJob j1) {
  mm::product_jobs<AM, BN, P>(j0, j1);
}

// Every partial summed in a fixed order, in one launch.
__global__ void __launch_bounds__(bt::kThreads) freq_sums_kernel(mm::SumJobs<10> s) {
  mm::column_sums(s);
}

// -- scratch layout and launches ---------------------------------------------

// The backward's scratch (on a null base: its size alone): B9's layout
// (ff::BwdLayout, operands of P parts) first, then in float32 only W_qkv and
// W_out split (P parts of 3C C and C C); bf16 operands (P = 3 parts in
// float32, 1 in bf16) W_qkv^T (P C 3C), W_out^T (P C C), g and go (P rows C
// each); q | k | v (rows 3C) and the rounded attention output (rows C) of
// T; float32 row norms (rows), gates (rows H), x2 (rows C; d_g once the FF
// half is done), d_x2 (rows C); the partials of dgamma_attn (tiles C), dW_g
// (tiles H C), db_g (tiles H) per 128-row tile and of dW_qkv (groups 3C C)
// and dW_out (groups C C). d_attn, d_o, d_z and d_qkv take the space of
// B9's first sections, free once the FF half is done.
template <typename T> struct Layout {
  ff::BwdLayout fs;  // B9's
  bf16 *wqkv, *wout, *wqkvt, *woutt, *g, *go, *da, *dqkv;
  T *qkv, *o, *dO;
  float *rn, *sig, *x2, *dg, *dx2, *dz;
  float *dgap, *dwgp, *dbgp, *dwqp, *dwop;
  int64_t groups;
  size_t bytes, late_bytes;

  Layout(void* base, int64_t rows, int C, int M, int64_t groups_, int64_t ff_groups)
      : fs(base, kParts<T>, rows, C, M, ff_groups), groups(groups_) {
    const int64_t P = kParts<T>, S = P > 1 ? P : 0, H = C / kHD, tiles = fs.tiles;
    mm::Carver c(reinterpret_cast<void*>(reinterpret_cast<uintptr_t>(base) + fs.bytes));
    wqkv = c.take<bf16>(S * 3 * C * C);
    wout = c.take<bf16>(S * C * C);
    wqkvt = c.take<bf16>(P * 3 * C * C);
    woutt = c.take<bf16>(P * C * C);
    g = c.take<bf16>(P * rows * C);
    go = c.take<bf16>(P * rows * C);
    qkv = c.take<T>(rows * 3 * C);
    o = c.take<T>(rows * C);
    rn = c.take<float>(rows);
    sig = c.take<float>(rows * H);
    x2 = dg = c.take<float>(rows * C);
    dx2 = c.take<float>(rows * C);
    dgap = c.take<float>(tiles * C);
    dwgp = c.take<float>(tiles * H * C);
    dbgp = c.take<float>(tiles * H);
    dwqp = c.take<float>(groups * 3 * C * C);
    dwop = c.take<float>(groups * C * C);
    bytes = fs.bytes + c.bytes;
    mm::Carver late(base);
    da = late.take<bf16>(P * rows * C);
    dO = late.take<T>(rows * C);
    dz = late.take<float>(rows * H);
    dqkv = late.take<bf16>(P * rows * 3 * C);
    late_bytes = late.bytes;
  }

  // The late sections fit in B9's first four.
  bool fits() const {
    return late_bytes <= (size_t)(reinterpret_cast<uintptr_t>(fs.w1t) -
                                  reinterpret_cast<uintptr_t>(fs.g));
  }
};

// Output tiles of the weight-gradient launch per row group: dW_qkv (3C, C)
// and dW_out (C, C) in blocks of kTM x product_n(C).
inline int wgrad_tiles(int C) {
  const int bn = mm::product_n(C);
  return (C + bn - 1) / bn * ((3 * C + kTM - 1) / kTM + (C + kTM - 1) / kTM);
}

template <int C, typename T>
cudaError_t launch_bwd(const Layout<T>& s, const T* x, const float* agamma, const T* wqkv,
                       const float* wg, const float* gb, const T* wout, const float* fgamma,
                       const T* w1, const float* b1, const T* w2, const float* cosv,
                       const float* sinv, const T* dout, T* dx, float* const* grads,
                       int64_t rows, int F, int M, int64_t group_rows, int64_t ff_group_rows,
                       bt::Dropout drop, cudaStream_t stream) {
  constexpr int P = kParts<T>;
  constexpr int H = C / kHD, BN = mm::product_n(C);
  const int64_t rlo = rows * C, tiles = s.fs.tiles;
  const unsigned mtiles = (unsigned)tiles, ntiles = (C + BN - 1) / BN;
  const size_t smem_nn = mm::product_smem<false, BN, P>();
  cudaError_t err;

  // 1-5. the attention half recomputed: x2 (float32)
  mm::ConvJobs conv;
  conv.add(wqkv, s.wqkvt, 3 * C, C, 1);
  conv.add(wout, s.woutt, C, C, 1);
  if (P > 1) {
    conv.add(wqkv, s.wqkv, 3 * C, C, 0);
    conv.add(wout, s.wout, C, C, 0);
  }
  if ((err = mm::convert<T, P>(conv, stream)) != cudaSuccess) return err;
  const Operand wqkv_op{P > 1 ? s.wqkv : (const bf16*)wqkv, C, (int64_t)3 * C * C};
  const Operand wout_op{P > 1 ? s.wout : (const bf16*)wout, C, (int64_t)C * C};

  freq_rows_kernel<C, T><<<mtiles, bt::kThreads, 0, stream>>>(x, agamma, wg, gb, s.rn, s.g, rlo,
                                                              s.sig, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto kq = freq_qkv_kernel<BN, T>;
  if ((err = bt::allow_smem(kq, smem_nn)) != cudaSuccess) return err;
  kq<<<dim3((3 * C + BN - 1) / BN, mtiles), bt::kThreads, smem_nn, stream>>>(
      Operand{s.g, C, rlo}, Operand{s.wqkvt, 3 * C, (int64_t)3 * C * C}, cosv, sinv, s.qkv, rows,
      C, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = fc::core_fwd<T>(s.qkv, s.sig, s.o, s.go, rlo, rows, C, F, drop, stream)) !=
      cudaSuccess)
    return err;

  auto ko = freq_out_kernel<BN, T>;
  if ((err = bt::allow_smem(ko, smem_nn)) != cudaSuccess) return err;
  ko<<<dim3(ntiles, mtiles), bt::kThreads, smem_nn, stream>>>(
      Operand{s.go, C, rlo}, Operand{s.woutt, C, (int64_t)C * C}, x, s.x2, rows, C, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 6. the feed-forward half on x2
  if ((err = ff::bwd_launch<C, T, float, P>(s.fs, s.x2, fgamma, w1, b1, w2, dout, s.dx2, rows, M,
                                         ff_group_rows, drop, stream)) != cudaSuccess)
    return err;

  // 7-9. the attention branch's backward to d_qkv
  const unsigned eblocks = (unsigned)std::min<int64_t>((rlo / 4 + bt::kThreads - 1) / bt::kThreads,
                                                       mm::kCardSMs * 16);
  freq_dattn_kernel<T><<<eblocks, bt::kThreads, 0, stream>>>(s.dx2, s.da, rlo, rows, C, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto kg = freq_dog_kernel<BN, T>;
  if ((err = bt::allow_smem(kg, smem_nn)) != cudaSuccess) return err;
  kg<<<dim3(ntiles, mtiles), bt::kThreads, smem_nn, stream>>>(Operand{s.da, C, rlo}, wout_op,
                                                              s.o, s.sig, s.dO, s.dz, rows, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = fc::core_bwd<T>(s.qkv, s.dO, cosv, sinv, s.dqkv, 3 * rlo, rows, C, F, drop,
                             stream)) != cudaSuccess)
    return err;

  // 10. d_g = d_qkv W_qkv
  const mm::ProductJob dgj{Operand{s.dqkv, 3 * C, 3 * rlo}, wqkv_op, s.dg, C, 0, rows, C,
                           3 * C, 3 * C, mtiles};
  auto kd = freq_product_kernel<false, BN, P>;
  if ((err = bt::allow_smem(kd, smem_nn)) != cudaSuccess) return err;
  kd<<<dim3(ntiles, mtiles), bt::kThreads, smem_nn, stream>>>(dgj, dgj);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 11. the RMSNorm backward to dx
  freq_post_kernel<C, T><<<mtiles, bt::kThreads, 0, stream>>>(
      x, agamma, wg, s.rn, s.dg, s.dz, s.dx2, dx, s.dgap, s.dwgp, s.dbgp, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 12. dW_qkv = d_qkv^T g and dW_out = d_attn^T go
  const mm::ProductJob wq{Operand{s.dqkv, 3 * C, 3 * rlo}, Operand{s.g, C, rlo}, s.dwqp, C,
                          (int64_t)3 * C * C, 3 * C, C, rows, group_rows,
                          (unsigned)((3 * C + kTM - 1) / kTM)};
  const mm::ProductJob wo{Operand{s.da, C, rlo}, Operand{s.go, C, rlo}, s.dwop, C,
                          (int64_t)C * C, C, C, rows, group_rows, (unsigned)((C + kTM - 1) / kTM)};
  auto kw = freq_product_kernel<true, BN, P>;
  const size_t smem_tn = mm::product_smem<true, BN, P>();
  if ((err = bt::allow_smem(kw, smem_tn)) != cudaSuccess) return err;
  kw<<<dim3(ntiles, wq.mtiles + wo.mtiles, (unsigned)s.groups), bt::kThreads, smem_tn, stream>>>(
      wq, wo);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 13. the fixed-order sums. grads: dga, dwqkv, dwg, dgb, dwout, dgf, dw1,
  // db1, dw2, db2
  mm::SumJobs<10> sums;
  ff::bwd_sums(s.fs, C, M, grads[5], grads[6], grads[7], grads[8], grads[9], sums, 0);
  sums.set(5, s.dgap, grads[0], tiles, C);
  sums.set(6, s.dwgp, grads[2], tiles, (int64_t)H * C);
  sums.set(7, s.dbgp, grads[3], tiles, H);
  sums.set(8, s.dwqp, grads[1], s.groups, (int64_t)3 * C * C);
  sums.set(9, s.dwop, grads[4], s.groups, (int64_t)C * C);
  freq_sums_kernel<<<sums.finish(), bt::kThreads, 0, stream>>>(sums);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(int C, const void* x, const void* agamma, const void* wqkv,
                         const void* wg, const void* gb, const void* wout, const void* fgamma,
                         const void* w1, const void* b1, const void* w2, const void* cosv,
                         const void* sinv, const void* dout, void* dx, float* const* grads,
                         void* scratch, int64_t scratch_bytes, int64_t rows, int F, int M,
                         int64_t group_rows, int64_t ff_group_rows, bt::Dropout drop,
                         cudaStream_t s) {
  const Layout<T> lay(scratch, rows, C, M, mm::row_groups(rows, group_rows),
                      mm::row_groups(rows, ff_group_rows));
  if ((int64_t)lay.bytes > scratch_bytes || !lay.fits()) return cudaErrorInvalidValue;
#define BT_CALL(CC)                                                                           \
  launch_bwd<CC, T>(lay, (const T*)x, (const float*)agamma, (const T*)wqkv, (const float*)wg, \
                    (const float*)gb, (const T*)wout, (const float*)fgamma, (const T*)w1,     \
                    (const float*)b1, (const T*)w2, (const float*)cosv, (const float*)sinv,   \
                    (const T*)dout, (T*)dx, grads, rows, F, M, group_rows, ff_group_rows,      \
                    drop, s)
  switch (C) {
    case 32: return BT_CALL(32);
    case 64: return BT_CALL(64);
    case 128: return BT_CALL(128);
    default: return cudaErrorInvalidValue;
  }
#undef BT_CALL
}

bool supported(int C) { return C == 32 || C == 64 || C == 128; }

}  // namespace

// Output tiles of bt_freq_train_bwd's attention weight-gradient launch per
// row group.
extern "C" int bt_freq_wgrad_tiles(int C, int* tiles) {
  if (!supported(C)) return (int)cudaErrorInvalidValue;
  *tiles = wgrad_tiles(C);
  return 0;
}

// Bytes of bt_freq_train_bwd's scratch for these arguments, in *bytes.
extern "C" int bt_freq_train_bwd_scratch(int dtype, int C, long long rows, int M,
                                         long long group_rows, long long ff_group_rows,
                                         long long* bytes) {
  if ((dtype != 0 && dtype != 1) || !supported(C) || rows < 0 || group_rows < 1 ||
      ff_group_rows < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t g = mm::row_groups(rows, group_rows), fg = mm::row_groups(rows, ff_group_rows);
  *bytes = (long long)(dtype == 0 ? Layout<float>(nullptr, rows, C, M, g, fg).bytes
                                  : Layout<bf16>(nullptr, rows, C, M, g, fg).bytes);
  return 0;
}

// dtype: 0 float32, 1 bfloat16 for x, dout, dx (rows, C), wqkv (3C, C), wout
// (C, C), w1 (M, C), w2 (C, M); agamma, wg (C/32, C), gb, fgamma, b1, cos/sin
// (F, 16) and the gradients are float32, in the parameters' torch layouts:
// dga (C), dwqkv (3C, C), dwg (C/32, C), dgb (C/32), dwout (C, C), dgf (C),
// dw1 (M, C), db1 (M), dw2 (C, M), db2 (C). scratch: scratch_bytes bytes, at
// least bt_freq_train_bwd_scratch's; the weight-gradient products take the
// rows in groups of group_rows (attention) and ff_group_rows (FF) >= 1
// (ops/fused_ff.py:ff_wgrad_split). F divides 32 and rows; M % 64 == 0.
// Dropout as bt_freq_train_fwd.
extern "C" int bt_freq_train_bwd(int dtype, int C, const void* x, const void* agamma,
                                 const void* wqkv, const void* wg, const void* gb,
                                 const void* wout, const void* fgamma, const void* w1,
                                 const void* b1, const void* w2, const void* cosv,
                                 const void* sinv, const void* dout, void* dx, void* dga,
                                 void* dwqkv, void* dwg, void* dgb, void* dwout, void* dgf,
                                 void* dw1, void* db1, void* dw2, void* db2, void* scratch,
                                 long long scratch_bytes, long long rows, int F, int M,
                                 long long group_rows, long long ff_group_rows, unsigned seed,
                                 unsigned salt, unsigned thr, float scale, int on, unsigned item0,
                                 unsigned row0, void* stream) {
  if (rows <= 0) return 0;
  if (F <= 0 || 32 % F || rows % F || M % ff::kHidN || group_rows < 1 || ff_group_rows < 1)
    return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on, item0, row0);
  float* const grads[10] = {(float*)dga, (float*)dwqkv, (float*)dwg, (float*)dgb, (float*)dwout,
                            (float*)dgf, (float*)dw1,   (float*)db1, (float*)dw2, (float*)db2};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? dispatch_bwd<float>(C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1,
                                                w2, cosv, sinv, dout, dx, grads, scratch,
                                                scratch_bytes, rows, F, M, group_rows,
                                                ff_group_rows, d, s)
               : dtype == 1
                   ? dispatch_bwd<__nv_bfloat16>(C, x, agamma, wqkv, wg, gb, wout, fgamma, w1,
                                                 b1, w2, cosv, sinv, dout, dx, grads, scratch,
                                                 scratch_bytes, rows, F, M, group_rows,
                                                 ff_group_rows, d, s)
                   : cudaErrorInvalidValue);
}
