// Fused frequency-axis roformer block, one launch, at eval and as the
// training forward:
//   y1  = x + drop(W_out (gate * softmax(rope(q) rope(k)^T / sqrt(32)) v)),
//   out = y1 + drop(W2 drop(gelu(W1 rmsnorm(y1) + b1)) + b2),
// where attention runs within each item of F consecutive rows (F frequency
// bins of one frame).
//
// Replaces beat_this_tpu/ops/fused_freq.py:_fused_freq_kernel, reached
// through fused_freq_roformer -> _fused_freq_fwd_call: at dropout rate 0
// (eval, bt_fused_freq) and at rate > 0 (the training forward,
// bt_freq_train_fwd; its backward is fused_freq_train.cu). The TPU kernel
// packs 128 / F items into one masked 128- or 512-row score tile to fill
// its matrix unit; here each item's F x F scores are computed directly by
// the thread that owns a (row, head) pair (freq_attn.cuh), so no off-item
// work is done.
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
// the ff_tail helper shared with the fused_ff kernels. Products are float32
// FMAs on the SIMT cores; bfloat16 inputs are widened on load, and
// intermediates are rounded to bfloat16 where the TPU kernel rounds them.
// The training variant (template flag TRAIN) adds the four dropout sites,
// masks drawn from Philox by element coordinates (philox.cuh), and rounds
// the dropped probabilities before the PV product; at eval the code path is
// the rate-0 kernel's.
#include "freq_attn.cuh"

namespace {

template <int C, typename T, bool TRAIN>
__global__ void __launch_bounds__(bt::kThreads)
    fused_freq_kernel(const T* __restrict__ x, const float* __restrict__ agamma,
                      const T* __restrict__ wqkv, const float* __restrict__ wg,
                      const float* __restrict__ gb, const T* __restrict__ wout,
                      const float* __restrict__ fgamma, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ cosv,
                      const float* __restrict__ sinv, T* __restrict__ out, int64_t rows, int F,
                      int M, float qscale, bt::Dropout drop) {
  constexpr int ld = bt::tile_ld(C);
  extern __shared__ float smem[];
  float* y = smem;                            // x, then y1
  float* scratch = y + bt::kRows * ld;        // ff_tail scratch
  float* g = scratch;                         // normed rows, then attention out
  float* ws = scratch + bt::kRows * ld + bt::kRows * (bt::kHid + 1);
  float* qkv = scratch + bt::ff_tail_floats<C>();  // kRows x (3C + 1)
  float* gate = qkv + bt::kRows * (3 * C + 1);     // kRows x H
  float* pmask = gate + bt::kRows * (C / bt::kHeadDim);  // TRAIN only
  const int64_t row0 = (int64_t)blockIdx.x * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);

  bt::load_rows<C, T>(x, y, row0, nrows);
  bt::rms_rows<C, true, T>(y, g, ld, agamma);
  bt::freq_attention<C, T, TRAIN>(y, g, qkv, gate, ws, pmask, wqkv, wg, gb, wout, cosv, sinv, F,
                                  qscale, row0, drop);
  bt::ff_tail<C, T>(y, scratch, fgamma, w1, b1, w2, b2, M, out, row0, nrows, drop);
}

template <int C, typename T, bool TRAIN>
cudaError_t launch(const void* x, const void* agamma, const void* wqkv, const void* wg,
                   const void* gb, const void* wout, const void* fgamma, const void* w1,
                   const void* b1, const void* w2, const void* b2, const void* cosv,
                   const void* sinv, void* out, int64_t rows, int F, int M, bt::Dropout drop,
                   cudaStream_t stream) {
  constexpr size_t smem = bt::freq_smem_bytes<C, TRAIN>();
  auto kernel = fused_freq_kernel<C, T, TRAIN>;
  cudaError_t err = bt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((rows + bt::kRows - 1) / bt::kRows);
  const float qscale = 0.17677669529663688f * 1.4426950408889634f;  // 32^-0.5 * log2(e)
  kernel<<<blocks, bt::kThreads, smem, stream>>>(
      (const T*)x, (const float*)agamma, (const T*)wqkv, (const float*)wg, (const float*)gb,
      (const T*)wout, (const float*)fgamma, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (const float*)cosv, (const float*)sinv, (T*)out, rows, F, M, qscale,
      drop);
  return cudaGetLastError();
}

template <typename T, bool TRAIN>
cudaError_t dispatch(int C, const void* x, const void* agamma, const void* wqkv, const void* wg,
                     const void* gb, const void* wout, const void* fgamma, const void* w1,
                     const void* b1, const void* w2, const void* b2, const void* cosv,
                     const void* sinv, void* out, int64_t rows, int F, int M, bt::Dropout drop,
                     cudaStream_t s) {
#define BT_CALL(CC)                                                                           \
  launch<CC, T, TRAIN>(x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv, sinv, out, \
                       rows, F, M, drop, s)
  switch (C) {
    case 32: return BT_CALL(32);
    case 64: return BT_CALL(64);
    case 128: return BT_CALL(128);
    default: return cudaErrorInvalidValue;
  }
#undef BT_CALL
}

template <bool TRAIN>
int entry(int dtype, int C, const void* x, const void* agamma, const void* wqkv, const void* wg,
          const void* gb, const void* wout, const void* fgamma, const void* w1, const void* b1,
          const void* w2, const void* b2, const void* cosv, const void* sinv, void* out,
          long long rows, int F, int M, bt::Dropout drop, void* stream) {
  if (rows <= 0) return 0;
  if (F <= 0 || bt::kRows % F || rows % F || M % bt::kHid) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0 ? dispatch<float, TRAIN>(C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2,
                                          b2, cosv, sinv, out, rows, F, M, drop, s)
      : dtype == 1
          ? dispatch<__nv_bfloat16, TRAIN>(C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2,
                                           b2, cosv, sinv, out, rows, F, M, drop, s)
          : cudaErrorInvalidValue;
  return (int)err;
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
  return entry<false>(dtype, C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv,
                      sinv, out, rows, F, M, bt::Dropout{}, stream);
}

// The training forward: as bt_fused_freq, with dropout at the four sites
// (keep iff the Philox bits < thr, kept values times scale; on == 0 turns
// it off) and the dropped probabilities rounded to the dtype.
extern "C" int bt_freq_train_fwd(int dtype, int C, const void* x, const void* agamma,
                                 const void* wqkv, const void* wg, const void* gb,
                                 const void* wout, const void* fgamma, const void* w1,
                                 const void* b1, const void* w2, const void* b2, const void* cosv,
                                 const void* sinv, void* out, long long rows, int F, int M,
                                 unsigned seed, unsigned salt, unsigned thr, float scale, int on,
                                 void* stream) {
  bt::Dropout d;
  d.seed = seed;
  d.salt = salt;
  d.thr = thr;
  d.scale = scale;
  d.on = on;
  return entry<true>(dtype, C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv, sinv,
                     out, rows, F, M, d, stream);
}
