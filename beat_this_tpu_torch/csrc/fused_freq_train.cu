// Backward of the fused frequency-axis block in training: dx and the ten
// parameter gradients (dgamma_attn, dW_qkv, dW_gates, db_gates, dW_out,
// dgamma_ff, dW1, db1, dW2, db2) of
//   y1  = x + drop(W_out (gate * attention)),
//   out = y1 + drop(W2 drop(gelu(W1 rmsnorm(y1) + b1)) + b2),
// with the four dropout masks regenerated from Philox by coordinates.
//
// Replaces beat_this_tpu/ops/fused_freq.py:_fused_freq_bwd_kernel (reached
// through _fused_freq_bwd). On the TPU one kernel accumulates every weight
// gradient across its sequential grid in VMEM; here blocks run in parallel
// and there are no float atomics, so the backward is three stages:
//
//   1. freq_bwd_rows: per 32-row tile, recompute the forward from x
//      (freq_attn.cuh, the training forward's own code), pull dout back
//      through the FF (hidden layer 64 units at a time, as fused_ff_train's
//      row launch), the output mask, the out projection, the gates and the
//      attention (one thread per (row, head) over the item's F keys: dq
//      query-major, then dk and dv key-major, recomputing each
//      probability), and through both RMSNorms to dx. It writes the per-row
//      operands of the four big weight gradients to scratch, rounded to the
//      compute dtype as the TPU kernel rounds them: (d_qkv, g), (d_attn,
//      og), (d_pre1, g2), (d_y, h1d); and per-tile partials of the small
//      gradients (both gammas, the gates' weight and bias, db1, db2).
//   2. atb (four launches): dW = A^T B over all rows for each pair, each
//      block a 32 x (32..128) output tile over one group of row tiles, one
//      float32 partial per group. The number of groups follows from the
//      shape (ops/fused_ff.py:wgrad_groups), so the grid fills the card.
//   3. sum_partials: the fixed-order sums of the partials, so two runs give
//      the same bits.
//
// Recompute versus scratch: the forward is recomputed per row tile (x is
// the only saved activation), and the operands of the weight gradients go
// through device memory once, 8 C + 2 M values per row in the compute dtype
// (786 MB at 384,000 rows of C 32 in float32), rather than recomputing the
// whole block once more per weight-gradient block. What bounds it on the
// H100: the row launch's float32 SIMT products (about 3x the forward's) and
// the attention, where at C 32 only one (row, head) thread in eight has
// work; the atb launches are bound by reading the scratch.
#include "freq_attn.cuh"

namespace {

template <typename T>
struct Operands {  // per-row operands of the weight gradients, (rows, width) each
  T *g, *dqkv, *og, *da, *g2, *dp1, *h1d, *dy;
};

struct Partials {  // per-row-tile partials of the small gradients
  float *dga, *dgf, *dbg, *dwg, *db1, *db2;
};

template <int C>
__host__ __device__ constexpr int rows_smem_floats() {
  constexpr int H = C / bt::kHeadDim, ld = bt::tile_ld(C), hld = bt::kHid + 1;
  return 6 * bt::kRows * ld + bt::kRows * (3 * C + 1) + 2 * bt::kRows * hld +
         bt::stage_floats(C > bt::kHid ? C : bt::kHid) + bt::pmask_floats<C>() +
         6 * bt::kRows * H + 2 * bt::kRows;
}

template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    freq_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ agamma,
                         const T* __restrict__ wqkv, const float* __restrict__ wg,
                         const float* __restrict__ gb, const T* __restrict__ wout,
                         const float* __restrict__ fgamma, const T* __restrict__ w1,
                         const float* __restrict__ b1, const T* __restrict__ w2,
                         const float* __restrict__ cosv, const float* __restrict__ sinv,
                         const T* __restrict__ dout, T* __restrict__ dx, Operands<T> op,
                         Partials pt, int64_t rows, int F, int M, float qscale,
                         bt::Dropout drop) {
  constexpr int H = C / bt::kHeadDim, D = bt::kHeadDim;
  constexpr int ld = bt::tile_ld(C), ldq = 3 * C + 1, hld = bt::kHid + 1;
  static_assert(bt::kRows * H <= bt::kThreads, "one thread per (row, head)");
  const float kscale = 0.17677669529663688f;  // 32^-0.5
  extern __shared__ float smem[];
  float* Y = smem;                   // x, then y1
  float* G = Y + bt::kRows * ld;     // g, og, g2, then round_T(d_attn)
  float* O = G + bt::kRows * ld;     // round_T(o)
  float* DY = O + bt::kRows * ld;    // round_T(d_y)
  float* DX2 = DY + bt::kRows * ld;  // d_x2, the cotangent of y1
  float* DO = DX2 + bt::kRows * ld;  // column-sum products, then round_T(d_o)
  float* QKV = DO + bt::kRows * ld;  // q, k, v, then d_q, d_k, d_v
  float* HC = QKV + bt::kRows * ldq;  // one chunk of round_T(d_pre1)
  float* DPF = HC + bt::kRows * hld;  // the same chunk unrounded (db1)
  float* WS = DPF + bt::kRows * hld;
  float* PM = WS + bt::stage_floats(C > bt::kHid ? C : bt::kHid);
  float* GATE = PM + bt::pmask_floats<C>();
  float* SIG = GATE + bt::kRows * H;
  float* MS = SIG + bt::kRows * H;
  float* LS = MS + bt::kRows * H;
  float* DELTA = LS + bt::kRows * H;
  float* DPG = DELTA + bt::kRows * H;  // d of the gate logits
  float* RN1 = DPG + bt::kRows * H;
  float* RN2 = RN1 + bt::kRows;
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
  const int64_t tile = blockIdx.x, row0 = tile * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);
  const float sc = sqrtf((float)C);

  // 1. recompute the forward's attention half: g, y1, og, o, the gates and
  // the softmax statistics
  bt::load_rows<C, T>(x, Y, row0, nrows);
  bt::rms_rows<C, true, T>(Y, G, ld, agamma, RN1);
  bt::store_rows<T>(G, ld, C, op.g, row0, nrows);
  bt::freq_attention<C, T, true>(Y, G, QKV, GATE, WS, PM, wqkv, wg, gb, wout, cosv, sinv, F,
                                 qscale, row0, drop, bt::FreqKeep{O, SIG, MS, LS});
  bt::store_rows<T>(G, ld, C, op.og, row0, nrows);

  // 2. the FF: g2, d_y, then the hidden layer 64 units at a time (h1d and
  // d_pre1 to scratch, db1 partials), accumulating d_g2 = d_pre1 W1
  bt::rms_rows<C, true, T>(Y, G, ld, fgamma, RN2);
  bt::store_rows<T>(G, ld, C, op.g2, row0, nrows);
  bt::load_dy<C, T>(dout, DY, row0, nrows, drop, pt.db2 + tile * C);
  bt::store_rows<T>(DY, ld, C, op.dy, row0, nrows);
  float acc[2][C / 16];
  bt::zero(acc);
  for (int j0 = 0; j0 < M; j0 += bt::kHid) {
    float hacc[2][bt::kHid / 16], dacc[2][bt::kHid / 16];
    bt::zero(hacc);
    bt::zero(dacc);
    bt::mm_acc<bt::kHid, T>(hacc, G, ld, w1, C, j0, C, WS);
    bt::mm_acc_t<bt::kHid, T>(dacc, DY, ld, w2, M, j0, C, WS);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < bt::kHid / 32; ++j) {
        const int r = rg + 16 * i, c0 = j0 + 2 * cp + 32 * j;
        float f[4];
        bt::keep4(drop, bt::kSiteFFHidden, 0, 0, (uint32_t)(row0 + r), c0 >> 2, f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pre = hacc[i][2 * j + e] + b1[c0 + e], fe = f[(c0 & 3) + e];
          const float d = dacc[i][2 * j + e] * fe * bt::gelu_grad(pre);
          const float db = bt::round_to<T>(d);
          DPF[r * hld + c0 - j0 + e] = d;
          HC[r * hld + c0 - j0 + e] = db;
          if (r < nrows) {
            op.h1d[(row0 + r) * M + c0 + e] = bt::from_f<T>(bt::gelu_exact(pre) * fe);
            op.dp1[(row0 + r) * M + c0 + e] = bt::from_f<T>(db);
          }
        }
      }
    __syncthreads();
    if (tid < bt::kHid) {
      float sum = 0.f;
      for (int r = 0; r < bt::kRows; ++r) sum += DPF[r * hld + tid];
      pt.db1[tile * M + j0 + tid] = sum;
    }
    bt::mm_acc_t<C, T>(acc, HC, hld, w1 + (size_t)j0 * C, C, 0, bt::kHid, WS);
  }

  // d_x2 = dout + (w - n2 (n2 . w)) / r2 with w = d_g2 gamma_ff sqrt(C), n2 =
  // y1 / r2; dgamma_ff's products into DO. Rows rg and rg + 16 are spread
  // over the 16 threads of a half warp.
  {
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < C / 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * cp + 32 * j + e;
          const float n = Y[r * ld + col] / RN2[r];
          s[i] += n * acc[i][2 * j + e] * fgamma[col] * sc;
          DO[r * ld + col] = acc[i][2 * j + e] * n * sc;
        }
#pragma unroll
      for (int o = 8; o; o >>= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < C / 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * cp + 32 * j + e;
          const float n = Y[r * ld + col] / RN2[r];
          const float w = acc[i][2 * j + e] * fgamma[col] * sc;
          DX2[r * ld + col] =
              r < nrows ? bt::to_f(dout[(row0 + r) * C + col]) + (w - n * s[i]) / RN2[r] : 0.f;
        }
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += bt::kThreads) {
    float sum = 0.f;
    for (int r = 0; r < bt::kRows; ++r) sum += DO[r * ld + c];
    pt.dgf[tile * C + c] = sum;
  }

  // 3. d_attn = round_T(d_x2 * output mask); d_og = d_attn W_out; d_o =
  // round_T(d_og * gate); the gate logits' cotangent from d_og . o per head
  for (int e = tid; e < bt::kRows * C; e += bt::kThreads) {
    const int r = e / C, c = e % C;
    G[r * ld + c] = r < nrows ? bt::round_to<T>(DX2[r * ld + c] *
                                                bt::keep1(drop, bt::kSiteAttnOut, 0, 0,
                                                          (uint32_t)(row0 + r), c))
                              : 0.f;
  }
  __syncthreads();  // also orders the DO reads above before the writes below
  bt::store_rows<T>(G, ld, C, op.da, row0, nrows);
  bt::zero(acc);
  bt::mm_acc_t<C, T>(acc, G, ld, wout, C, 0, C, WS);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg + 16 * i;
#pragma unroll
    for (int j = 0; j < H; ++j) {  // head j holds columns 32 j .. 32 j + 31
      float dsig = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * cp + 32 * j + e;
        const float dog = acc[i][2 * j + e];
        DO[r * ld + col] = bt::round_to<T>(dog * GATE[r * H + j]);
        dsig += dog * O[r * ld + col];
      }
#pragma unroll
      for (int o = 8; o; o >>= 1) dsig += __shfl_xor_sync(0xffffffffu, dsig, o);
      if (cp == 0) {
        const float sg = SIG[r * H + j];
        DPG[r * H + j] = dsig * sg * (1.f - sg);
      }
    }
  }
  __syncthreads();
  if (tid < H) {
    float sum = 0.f;
    for (int r = 0; r < bt::kRows; ++r) sum += DPG[r * H + tid];
    pt.dbg[tile * H + tid] = sum;
  }
  // dW_gates from the rounded rows g this block stored in step 1
  for (int e = tid; e < H * C; e += bt::kThreads) {
    const int h = e / C, c = e % C;
    float sum = 0.f;
    for (int r = 0; r < nrows; ++r)
      sum += bt::round_to<T>(DPG[r * H + h]) * bt::to_f(op.g[(row0 + r) * C + c]);
    pt.dwg[tile * H * C + e] = sum;
  }

  // 4. attention backward, one thread per (row, head): first as the query
  // (delta = sum p dp over the undropped p, then dq), then as the key (dk,
  // dv), recomputing each probability from the saved max and sum
  const bool active = tid < bt::kRows * H;
  const int r = tid / H, h = tid % H, first = r - r % F;
  float dq[D], dk[D], dv[D];
  if (active) {
    const float* qr = QKV + r * ldq + h * D;
    const float* dor = DO + r * ld + h * D;
    const float* pm = PM + (r * H + h) * F;
    const float m = MS[r * H + h], linv = 1.f / LS[r * H + h];
    float delta = 0.f;
    for (int j = first; j < first + F; ++j) {
      const float* kr = QKV + j * ldq + C + h * D;
      const float* vr = kr + C;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s += qr[d] * qscale * kr[d];  // the forward's score, bit for bit
        dp += dor[d] * vr[d];
      }
      delta += exp2f(s - m) * linv * dp * pm[j - first];
    }
    DELTA[r * H + h] = delta;
#pragma unroll
    for (int d = 0; d < D; ++d) dq[d] = 0.f;
    for (int j = first; j < first + F; ++j) {
      const float* kr = QKV + j * ldq + C + h * D;
      const float* vr = kr + C;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s += qr[d] * qscale * kr[d];  // the forward's score, bit for bit
        dp += dor[d] * vr[d];
      }
      const float p = exp2f(s - m) * linv;
      const float ds = bt::round_to<T>(p * (dp * pm[j - first] - delta));
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] += ds * kr[d];
    }
  }
  __syncthreads();
  if (active) {
    const float* kr = QKV + r * ldq + C + h * D;
    const float* vr = kr + C;
#pragma unroll
    for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;
    for (int q = first; q < first + F; ++q) {
      const float* qr = QKV + q * ldq + h * D;
      const float* dor = DO + q * ld + h * D;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s += qr[d] * qscale * kr[d];  // the forward's score, bit for bit
        dp += dor[d] * vr[d];
      }
      const float keep = PM[(q * H + h) * F + r - first];
      const float p = exp2f(s - MS[q * H + h]) / LS[q * H + h];
      const float ds = bt::round_to<T>(p * (dp * keep - DELTA[q * H + h]));
      const float pd = bt::round_to<T>(p * keep);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dk[d] += ds * qr[d];
        dv[d] += pd * dor[d];
      }
    }
  }
  __syncthreads();  // every read of q, k, v is done: overwrite them in place
  if (active) {
    // dq, dk: the inverse RoPE at this row's position, times 32^-0.5
    const int pos = r % F;
    float* out = QKV + r * ldq + h * D;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const float cs = cosv[pos * (D / 2) + i], sn = sinv[pos * (D / 2) + i];
      out[2 * i] = bt::round_to<T>((dq[2 * i] * cs + dq[2 * i + 1] * sn) * kscale);
      out[2 * i + 1] = bt::round_to<T>((dq[2 * i + 1] * cs - dq[2 * i] * sn) * kscale);
      out[C + 2 * i] = bt::round_to<T>((dk[2 * i] * cs + dk[2 * i + 1] * sn) * kscale);
      out[C + 2 * i + 1] = bt::round_to<T>((dk[2 * i + 1] * cs - dk[2 * i] * sn) * kscale);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) out[2 * C + d] = bt::round_to<T>(dv[d]);
  }
  __syncthreads();
  bt::store_rows<T>(QKV, ldq, 3 * C, op.dqkv, row0, nrows);

  // 5. d_g = round_T(d_gate_logits) W_gates + d_qkv W_qkv; dx = d_x2 + (w -
  // n1 (n1 . w)) / r1 with w = d_g gamma_attn sqrt(C), n1 = x / r1;
  // dgamma_attn's products into DO
  bt::zero(acc);
  bt::mm_acc_t<C, T>(acc, QKV, ldq, wqkv, C, 0, 3 * C, WS);
  {
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < C / 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * cp + 32 * j + e;
          float dg = acc[i][2 * j + e];
          for (int hh = 0; hh < H; ++hh)
            dg += bt::round_to<T>(DPG[rr * H + hh]) * wg[hh * C + col];
          acc[i][2 * j + e] = dg;
          const float n = rr < nrows ? bt::to_f(x[(row0 + rr) * C + col]) / RN1[rr] : 0.f;
          s[i] += n * dg * agamma[col] * sc;
          DO[rr * ld + col] = dg * n * sc;
        }
#pragma unroll
      for (int o = 8; o; o >>= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = rg + 16 * i;
      if (rr >= nrows) continue;
#pragma unroll
      for (int j = 0; j < C / 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * cp + 32 * j + e;
          const int64_t at = (row0 + rr) * C + col;
          const float n = bt::to_f(x[at]) / RN1[rr];
          const float w = acc[i][2 * j + e] * agamma[col] * sc;
          dx[at] = bt::from_f<T>(DX2[rr * ld + col] + (w - n * s[i]) / RN1[rr]);
        }
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += bt::kThreads) {
    float sum = 0.f;
    for (int rr = 0; rr < bt::kRows; ++rr) sum += DO[rr * ld + c];
    pt.dga[tile * C + c] = sum;
  }
}

// part[g][a][b] = sum over the rows of row-tile group g (blockIdx.z) of
// A[row][a] * B[row][b], for the block's 32 columns a of A (blockIdx.x) and
// 32 NI columns b of B (blockIdx.y). A (rows, ka) and B (rows, kb) in T.
template <int NI, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    atb_kernel(const T* __restrict__ A, int ka, const T* __restrict__ B, int kb,
               float* __restrict__ part, int64_t rows, int tiles_per_group) {
  constexpr int cl = 33, rl = 32 * NI + 1;
  __shared__ float L[bt::kRows * cl];
  __shared__ float R[bt::kRows * rl];
  const int tid = threadIdx.x, a0 = blockIdx.x * 32, b0 = blockIdx.y * 32 * NI, g = blockIdx.z;
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
    for (int e = tid; e < bt::kRows * 32; e += bt::kThreads) {
      const int r = e / 32, c = e % 32;
      L[r * cl + c] = r < nrows ? bt::to_f(A[(row0 + r) * ka + a0 + c]) : 0.f;
    }
    for (int e = tid; e < bt::kRows * 32 * NI; e += bt::kThreads) {
      const int r = e / (32 * NI), c = e % (32 * NI);
      R[r * rl + c] = r < nrows ? bt::to_f(B[(row0 + r) * kb + b0 + c]) : 0.f;
    }
    __syncthreads();
    bt::outer_acc<NI>(acc, L, cl, R, rl);
    __syncthreads();
  }
  const int lane = tid & 31, l0 = 4 * (tid >> 5);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < NI; ++i)
      part[(size_t)g * ka * kb + (size_t)(a0 + l0 + a) * kb + b0 + lane + 32 * i] = acc[a][i];
}

// out (ka, kb) = A^T B over all rows: grouped partials, then their
// fixed-order sum. part: groups * ka * kb floats.
template <typename T>
cudaError_t atb(const T* A, int ka, const T* B, int kb, float* part, float* out, int64_t rows,
                int groups, cudaStream_t s) {
  const int64_t tiles = (rows + bt::kRows - 1) / bt::kRows;
  const int tpg = (int)((tiles + groups - 1) / groups);
  const int ni = kb >= 128 ? 4 : kb / 32;
  const dim3 grid(ka / 32, kb / (32 * ni), groups);
  switch (ni) {
    case 1: atb_kernel<1, T><<<grid, bt::kThreads, 0, s>>>(A, ka, B, kb, part, rows, tpg); break;
    case 2: atb_kernel<2, T><<<grid, bt::kThreads, 0, s>>>(A, ka, B, kb, part, rows, tpg); break;
    default: atb_kernel<4, T><<<grid, bt::kThreads, 0, s>>>(A, ka, B, kb, part, rows, tpg);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return bt::sum_partials(part, out, groups, (int64_t)ka * kb, s);
}

template <int C, typename T>
cudaError_t launch_bwd(const void* x, const void* agamma, const void* wqkv, const void* wg,
                       const void* gb, const void* wout, const void* fgamma, const void* w1,
                       const void* b1, const void* w2, const void* cosv, const void* sinv,
                       const void* dout, void* dx, float* const* grads, void* ops, void* part,
                       int64_t rows, int F, int M, int groups, bt::Dropout drop,
                       cudaStream_t s) {
  constexpr int H = C / bt::kHeadDim;
  const int64_t tiles = (rows + bt::kRows - 1) / bt::kRows;
  Operands<T> op;
  op.g = (T*)ops;
  op.dqkv = op.g + rows * C;
  op.og = op.dqkv + rows * 3 * C;
  op.da = op.og + rows * C;
  op.g2 = op.da + rows * C;
  op.dp1 = op.g2 + rows * C;
  op.h1d = op.dp1 + rows * M;
  op.dy = op.h1d + rows * M;
  Partials pt;
  pt.dga = (float*)part;
  pt.dgf = pt.dga + tiles * C;
  pt.dbg = pt.dgf + tiles * C;
  pt.dwg = pt.dbg + tiles * H;
  pt.db1 = pt.dwg + tiles * H * C;
  pt.db2 = pt.db1 + tiles * M;
  float* gp = pt.db2 + tiles * C;  // group partials, reused by the four products in turn

  const size_t smem = sizeof(float) * rows_smem_floats<C>();
  auto k1 = freq_bwd_rows_kernel<C, T>;
  cudaError_t err = bt::allow_smem(k1, smem);
  if (err != cudaSuccess) return err;
  const float qscale = 0.17677669529663688f * 1.4426950408889634f;  // 32^-0.5 * log2(e)
  k1<<<(unsigned)tiles, bt::kThreads, smem, s>>>(
      (const T*)x, (const float*)agamma, (const T*)wqkv, (const float*)wg, (const float*)gb,
      (const T*)wout, (const float*)fgamma, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)cosv, (const float*)sinv, (const T*)dout, (T*)dx, op, pt, rows, F, M, qscale,
      drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // grads: dga, dwqkv, dwg, dgb, dwout, dgf, dw1, db1, dw2, db2
  if ((err = atb<T>(op.dqkv, 3 * C, op.g, C, gp, grads[1], rows, groups, s)) != cudaSuccess)
    return err;
  if ((err = atb<T>(op.da, C, op.og, C, gp, grads[4], rows, groups, s)) != cudaSuccess) return err;
  if ((err = atb<T>(op.dp1, M, op.g2, C, gp, grads[6], rows, groups, s)) != cudaSuccess) return err;
  if ((err = atb<T>(op.dy, C, op.h1d, M, gp, grads[8], rows, groups, s)) != cudaSuccess) return err;
  const struct { const float* p; float* out; int64_t n; } small[] = {
      {pt.dga, grads[0], C}, {pt.dwg, grads[2], (int64_t)H * C}, {pt.dbg, grads[3], H},
      {pt.dgf, grads[5], C}, {pt.db1, grads[7], M},               {pt.db2, grads[9], C}};
  for (const auto& t : small)
    if ((err = bt::sum_partials(t.p, t.out, (int)tiles, t.n, s)) != cudaSuccess) return err;
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_bwd(int C, const void* x, const void* agamma, const void* wqkv,
                         const void* wg, const void* gb, const void* wout, const void* fgamma,
                         const void* w1, const void* b1, const void* w2, const void* cosv,
                         const void* sinv, const void* dout, void* dx, float* const* grads,
                         void* ops, void* part, int64_t rows, int F, int M, int groups,
                         bt::Dropout drop, cudaStream_t s) {
#define BT_CALL(CC)                                                                          \
  launch_bwd<CC, T>(x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, cosv, sinv, dout, dx, \
                    grads, ops, part, rows, F, M, groups, drop, s)
  switch (C) {
    case 32: return BT_CALL(32);
    case 64: return BT_CALL(64);
    case 128: return BT_CALL(128);
    default: return cudaErrorInvalidValue;
  }
#undef BT_CALL
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 for x, dout, dx (rows, C), wqkv (3C, C), wout
// (C, C), w1 (M, C), w2 (C, M) and the operand scratch `ops` (rows * (8 C +
// 2 M) values); agamma, wg (C/32, C), gb, fgamma, b1, cos/sin (F, 16) and
// the gradients are float32, in the parameters' torch layouts: dga (C),
// dwqkv (3C, C), dwg (C/32, C), dgb (C/32), dwout (C, C), dgf (C), dw1 (M,
// C), db1 (M), dw2 (C, M), db2 (C). part: ceil(rows / 32) * (3 C + C/32 +
// C/32 * C + M) + groups * max(3 C * C, M * C) floats; 1 <= groups <=
// ceil(rows / 32). F divides 32 and rows. Dropout as bt_freq_train_fwd.
extern "C" int bt_freq_train_bwd(int dtype, int C, const void* x, const void* agamma,
                                 const void* wqkv, const void* wg, const void* gb,
                                 const void* wout, const void* fgamma, const void* w1,
                                 const void* b1, const void* w2, const void* cosv,
                                 const void* sinv, const void* dout, void* dx, void* dga,
                                 void* dwqkv, void* dwg, void* dgb, void* dwout, void* dgf,
                                 void* dw1, void* db1, void* dw2, void* db2, void* ops,
                                 void* part, long long rows, int F, int M, int groups,
                                 unsigned seed, unsigned salt, unsigned thr, float scale, int on,
                                 void* stream) {
  if (rows <= 0) return 0;
  if (F <= 0 || bt::kRows % F || rows % F || M % bt::kHid || groups < 1)
    return (int)cudaErrorInvalidValue;
  bt::Dropout d;
  d.seed = seed;
  d.salt = salt;
  d.thr = thr;
  d.scale = scale;
  d.on = on;
  float* const grads[10] = {(float*)dga, (float*)dwqkv, (float*)dwg, (float*)dgb, (float*)dwout,
                            (float*)dgf, (float*)dw1,   (float*)db1, (float*)dw2, (float*)db2};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? dispatch_bwd<float>(C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1,
                                                w2, cosv, sinv, dout, dx, grads, ops, part, rows,
                                                F, M, groups, d, s)
               : dtype == 1
                   ? dispatch_bwd<__nv_bfloat16>(C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1,
                                                 w2, cosv, sinv, dout, dx, grads, ops, part, rows,
                                                 F, M, groups, d, s)
                   : cudaErrorInvalidValue);
}
