// Fused frequency-axis roformer block (eval), one launch:
//   y1  = x + W_out (gate * softmax(rope(q) rope(k)^T / sqrt(32)) v),
//   out = y1 + FF(y1),
// where attention runs within each item of F consecutive rows (F frequency
// bins of one frame).
//
// Replaces beat_this_tpu/ops/fused_freq.py:_fused_freq_kernel at dropout rate
// 0 (reached through fused_freq_roformer -> _fused_freq_fwd_call). The TPU
// kernel packs 128 / F items into one masked 128- or 512-row score tile to
// fill its matrix unit; here each item's F x F scores are computed directly
// by the thread that owns a (row, head) pair, so no off-item work is done.
//
// Bound on the H100: arithmetic at C = 128 (the projections cost 24 C^2 FLOP
// per row against 2 C values moved), memory at C = 32, where a row is 128 B
// f32 in and out for ~25 KFLOP. The block is one pass over the rows either
// way: x is read once and out written once, and everything between (norm,
// q/k/v, scores, the gated attention output, the residual and the FF hidden
// layer) stays in the block's shared memory or registers.
//
// Design: one 256-thread block per 32-row tile (32 / F whole items, F in
// {1, 2, 4, 8, 16, 32}). Weights are not held resident: every product
// streams its weight through shared memory 16 input features at a time with
// the mm_acc helper, and the FF hidden layer goes 64 units at a time through
// the ff_tail helper shared with the fused_ff kernel. Products are float32
// FMAs on the SIMT cores; bfloat16 inputs are widened on load, and
// intermediates are rounded to bfloat16 where the TPU kernel rounds them.
#include "common.cuh"

namespace {

template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    fused_freq_kernel(const T* __restrict__ x, const float* __restrict__ agamma,
                      const T* __restrict__ wqkv, const float* __restrict__ wg,
                      const float* __restrict__ gb, const T* __restrict__ wout,
                      const float* __restrict__ fgamma, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ cosv,
                      const float* __restrict__ sinv, T* __restrict__ out, int64_t rows, int F,
                      int M, float qscale) {
  constexpr int H = C / bt::kHeadDim, ld = bt::tile_ld(C), ldq = 3 * C + 1;
  constexpr int NT = C;  // q/k/v column tile: one third of the projection
  extern __shared__ float smem[];
  float* y = smem;                            // x, then y1
  float* scratch = y + bt::kRows * ld;        // ff_tail scratch
  float* g = scratch;                         // normed rows, then attention out
  float* ws = scratch + bt::kRows * ld + bt::kRows * (bt::kHid + 1);
  float* qkv = scratch + bt::ff_tail_floats<C>();  // kRows x ldq
  float* gate = qkv + bt::kRows * ldq;             // kRows x H
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
  const int64_t row0 = (int64_t)blockIdx.x * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);

  bt::load_rows<C, T>(x, y, row0, nrows);
  bt::rms_rows<C, true, T>(y, g, ld, agamma);
  for (int e = tid; e < bt::kRows * H; e += bt::kThreads) {
    const int r = e / H, h = e % H;
    float z = 0.f;
    for (int c = 0; c < C; ++c) z += g[r * ld + c] * wg[h * C + c];
    gate[r * H + h] = bt::round_to<T>(1.f / (1.f + expf(-(z + gb[h]))));
  }
  // q, k, v rounded to T (the TPU kernel's qkv is in the compute dtype), then
  // RoPE on q and k at position r % F (tiles start on item boundaries)
  for (int n0 = 0; n0 < 3 * C; n0 += NT) {
    float acc[2][NT / 16];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT / 16; ++j) acc[i][j] = 0.f;
    bt::mm_acc<NT, T>(acc, g, ld, wqkv, C, n0, C, ws);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg + 16 * i, pos = r % F;
#pragma unroll
      for (int j = 0; j < NT / 32; ++j) {
        const int col = n0 + 2 * cp + 32 * j, d = col % bt::kHeadDim;
        float a = bt::round_to<T>(acc[i][2 * j]), b = bt::round_to<T>(acc[i][2 * j + 1]);
        if (col < 2 * C) {
          const float cs = cosv[pos * (bt::kHeadDim / 2) + d / 2];
          const float sn = sinv[pos * (bt::kHeadDim / 2) + d / 2];
          const float ra = bt::round_to<T>(a * cs - b * sn);
          const float rb = bt::round_to<T>(b * cs + a * sn);
          a = ra;
          b = rb;
        }
        qkv[r * ldq + col] = a;
        qkv[r * ldq + col + 1] = b;
      }
    }
  }
  __syncthreads();  // also orders the gate writes before their reads below

  // attention within each item: one thread per (row, head), online softmax
  for (int e = tid; e < bt::kRows * H; e += bt::kThreads) {
    const int r = e / H, h = e % H, first = r - r % F;
    const float* qr = qkv + r * ldq + h * bt::kHeadDim;
    float qv[bt::kHeadDim], o[bt::kHeadDim];
#pragma unroll
    for (int d = 0; d < bt::kHeadDim; ++d) {
      qv[d] = qr[d] * qscale;
      o[d] = 0.f;
    }
    float m = -INFINITY, l = 0.f;
    for (int j = first; j < first + F; ++j) {
      const float* kr = qkv + j * ldq + C + h * bt::kHeadDim;
      const float* vr = kr + C;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < bt::kHeadDim; ++d) s += qv[d] * kr[d];
      const float mn = fmaxf(m, s), corr = exp2f(m - mn), p = exp2f(s - mn);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < bt::kHeadDim; ++d) o[d] = o[d] * corr + p * vr[d];
      m = mn;
    }
    // g is free once q/k/v and the gates are computed
    const float gt = gate[r * H + h];
#pragma unroll
    for (int d = 0; d < bt::kHeadDim; ++d)
      g[r * ld + h * bt::kHeadDim + d] = bt::round_to<T>(bt::round_to<T>(o[d] / l) * gt);
  }
  __syncthreads();

  // y1 = x + W_out o, in place over x (each element is read and written by
  // the thread that owns it)
  for (int n0 = 0; n0 < C; n0 += NT) {
    float acc[2][NT / 16];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT / 16; ++j) acc[i][j] = 0.f;
    bt::mm_acc<NT, T>(acc, g, ld, wout, C, n0, C, ws);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT / 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 2 * cp + 32 * j + e;
          y[(rg + 16 * i) * ld + col] += acc[i][2 * j + e];
        }
  }
  __syncthreads();
  bt::ff_tail<C, T>(y, scratch, fgamma, w1, b1, w2, b2, M, out, row0, nrows);
}

template <int C>
constexpr size_t freq_smem_bytes() {
  constexpr int H = C / bt::kHeadDim;
  return sizeof(float) * (bt::kRows * bt::tile_ld(C) + bt::ff_tail_floats<C>() +
                          bt::kRows * (3 * C + 1) + bt::kRows * H);
}

template <int C, typename T>
cudaError_t launch(const void* x, const void* agamma, const void* wqkv, const void* wg,
                   const void* gb, const void* wout, const void* fgamma, const void* w1,
                   const void* b1, const void* w2, const void* b2, const void* cosv,
                   const void* sinv, void* out, int64_t rows, int F, int M,
                   cudaStream_t stream) {
  constexpr size_t smem = freq_smem_bytes<C>();
  auto kernel = fused_freq_kernel<C, T>;
  cudaError_t err = bt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((rows + bt::kRows - 1) / bt::kRows);
  const float qscale = 0.17677669529663688f * 1.4426950408889634f;  // 32^-0.5 * log2(e)
  kernel<<<blocks, bt::kThreads, smem, stream>>>(
      (const T*)x, (const float*)agamma, (const T*)wqkv, (const float*)wg, (const float*)gb,
      (const T*)wout, (const float*)fgamma, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (const float*)cosv, (const float*)sinv, (T*)out, rows, F, M, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int C, const void* x, const void* agamma, const void* wqkv, const void* wg,
                     const void* gb, const void* wout, const void* fgamma, const void* w1,
                     const void* b1, const void* w2, const void* b2, const void* cosv,
                     const void* sinv, void* out, int64_t rows, int F, int M,
                     cudaStream_t s) {
  switch (C) {
    case 32:
      return launch<32, T>(x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv, sinv,
                           out, rows, F, M, s);
    case 64:
      return launch<64, T>(x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv, sinv,
                           out, rows, F, M, s);
    case 128:
      return launch<128, T>(x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv, sinv,
                            out, rows, F, M, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 for x, wqkv (3C, C), wout (C, C), w1 (M, C),
// w2 (C, M) and out; agamma, wg (C/32, C), gb, fgamma, b1, b2 and cos/sin
// (F, 16) are float32. x and out are (items * F, C); F divides 32.
extern "C" int bt_fused_freq(int dtype, int C, const void* x, const void* agamma,
                             const void* wqkv, const void* wg, const void* gb, const void* wout,
                             const void* fgamma, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* cosv, const void* sinv, void* out,
                             long long rows, int F, int M, void* stream) {
  if (rows <= 0) return 0;
  if (F <= 0 || bt::kRows % F || rows % F || M % bt::kHid) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0 ? dispatch<float>(C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2,
                                   cosv, sinv, out, rows, F, M, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1,
                                             w2, b2, cosv, sinv, out, rows, F, M, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
