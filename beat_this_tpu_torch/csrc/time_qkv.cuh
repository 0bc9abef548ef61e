// The first launches of the time-axis roformer blocks, shared by the eval
// block (fused_time.cu, K2) and the training forward (fused_time_train.cu,
// B4), once the caller's conversion launch has made W_qkv^T an operand:
//   1. rows: per 32 rows, g = round_T(rmsnorm(x) gamma) as an operand of P
//      parts, and the per-head gates sigmoid(gn W_g + b_g) from the
//      unrounded float32 normed rows gn and the float32 W_g, as the TPU
//      kernel takes them (beat_this_tpu/ops/fused_time.py:178-181);
//   2. qkv:  g W_qkv^T on the staged tensor-core product (tc_product.cuh,
//      P-part operands); the epilogue applies RoPE to q and k (interleaved
//      pairs, half-width tables) on the float32 product and rounds once, as
//      the TPU kernel does, into q, k, v as (items, heads, n, 32): values of
//      T (what the training forward saves for its backward) and/or the
//      attention's operands of PO parts.
#pragma once

#include "tc_product.cuh"

namespace {
namespace tq {

using bf16 = __nv_bfloat16;
using mm::kTM;
using mm::Operand;

constexpr int kHD = bt::kHeadDim;  // 32

constexpr int kRowsPass = 32;  // rows per block of the row pass

// Per 32 rows of x (rows, C): g as an operand (parts `lo` apart) and the
// float32 gates (rows, C / 32). W_g is staged in shared memory; a lane reads
// its four columns of a head as one float4, so the warp's reads are
// conflict-free.
template <int C, typename T, int P>
__global__ void __launch_bounds__(bt::kThreads)
    time_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ wg, const float* __restrict__ gb,
                     bf16* __restrict__ g, int64_t lo, float* __restrict__ gates, int64_t rows) {
  constexpr int H = C / kHD;
  using RM = mm::RowMap<C>;
  __shared__ __align__(16) float wgs[H * C];
  for (int e = threadIdx.x; e < H * C / 4; e += bt::kThreads)
    reinterpret_cast<float4*>(wgs)[e] = reinterpret_cast<const float4*>(wg)[e];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane % RM::L;
  const float sc = sqrtf((float)C);
  for (int rr = warp * RM::RPW + lane / RM::L; rr < kRowsPass; rr += 8 * RM::RPW) {
    const int64_t r = (int64_t)blockIdx.x * kRowsPass + rr;
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
      for (int e = 0; e < 4; ++e) gv[e] = xv[i][e] / nrm * sc * gamma[col + e];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 w = *reinterpret_cast<const float4*>(wgs + h * C + col);
        z[h] += gv[0] * w.x + gv[1] * w.y + gv[2] * w.z + gv[3] * w.w;
      }
      if (ok) mm::store4<P>(g + r * C + col, lo, gv);
    }
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int o = RM::L / 2; o; o >>= 1) z[h] += __shfl_xor_sync(0xffffffffu, z[h], o);
    if (ok && q == 0) {
#pragma unroll
      for (int h = 0; h < H; ++h) gates[r * H + h] = 1.f / (1.f + expf(-(z[h] + gb[h])));
    }
  }
}

// q, k, v = g W_qkv^T (A: g, B: W_qkv^T, operands of P parts) with RoPE on q
// and k at position row % n, each written where its pointer is not null:
// as values of T into q, k, v, and as operands of PO parts into op (q at
// op, k at op + PO lo, v at op + 2 PO lo, each part `lo` elements after the
// one before). A thread's C fragment holds column pairs (2i, 2i + 1): one
// rotation pair.
template <int BN, typename T, int P, int PO>
__global__ void __launch_bounds__(bt::kThreads)
    time_qkv_kernel(Operand A, Operand B, const float* __restrict__ cosv,
                    const float* __restrict__ sinv, T* __restrict__ q, T* __restrict__ k,
                    T* __restrict__ v, bf16* __restrict__ op, int64_t lo, int64_t rows, int n,
                    int C) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int64_t m0 = (int64_t)blockIdx.y * kTM;
  const int n0 = blockIdx.x * BN;
  float acc[2][BN / 16][4];
  mm::product<false, BN, P>(acc, A, B, m0, n0, 0, C, rows, 3 * C,
                            reinterpret_cast<bf16*>(smem_b));
  const int H = C / kHD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp & 3), wn = (BN / 2) * (warp >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t row = m0 + wm + 16 * mi + (lane >> 2) + 8 * hh;
      if (row >= rows) continue;
      const int64_t item = row / n;
      const int t = (int)(row % n);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        const int col = n0 + wn + 8 * j + 2 * (lane & 3);
        if (col >= 3 * C) continue;
        const int which = col / C, w = col % C, d = w % kHD;
        float a = acc[mi][j][2 * hh], b = acc[mi][j][2 * hh + 1];
        if (which < 2) {
          const float cs = cosv[t * (kHD / 2) + d / 2], sn = sinv[t * (kHD / 2) + d / 2];
          const float ra = a * cs - b * sn, rb = b * cs + a * sn;
          a = ra;
          b = rb;
        }
        const int64_t at = ((item * H + w / kHD) * n + t) * kHD + d;
        T* dst = which == 0 ? q : which == 1 ? k : v;
        if (dst != nullptr) {
          dst[at] = bt::from_f<T>(a);
          dst[at + 1] = bt::from_f<T>(b);
        }
        if (op != nullptr) mm::store2<PO>(op + which * PO * lo + at, lo, a, b);
      }
    }
}

// The two launches over rows = items * n rows of x: g (P parts, rows C,
// scratch) and the gates (rows, C / 32), then q, k, v (values and/or PO-part
// operands with lo = rows C, as time_qkv_kernel). W_qkv^T is the operand
// wqkv_t (C x 3C, P parts).
template <int C, typename T, int P, int PO>
cudaError_t qkv_launch(const T* x, const float* gamma, Operand wqkv_t, const float* wg,
                       const float* gb, const float* cosv, const float* sinv, bf16* g,
                       float* gates, T* q, T* k, T* v, bf16* op, int64_t rows, int n,
                       cudaStream_t stream) {
  constexpr int BN = mm::product_n(C);
  const int64_t rlo = rows * C;
  const unsigned mtiles = (unsigned)((rows + kTM - 1) / kTM);
  time_rows_kernel<C, T, P><<<(unsigned)((rows + kRowsPass - 1) / kRowsPass), bt::kThreads, 0,
                              stream>>>(x, gamma, wg, gb, g, rlo, gates, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kq = time_qkv_kernel<BN, T, P, PO>;
  const size_t smem = mm::product_smem<false, BN, P>();
  if ((err = bt::allow_smem(kq, smem)) != cudaSuccess) return err;
  kq<<<dim3((unsigned)((3 * C + BN - 1) / BN), mtiles), bt::kThreads, smem, stream>>>(
      Operand{g, C, rlo}, wqkv_t, cosv, sinv, q, k, v, op, rlo, rows, n, C);
  return cudaGetLastError();
}

}  // namespace tq
}  // namespace
