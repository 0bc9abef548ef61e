// Fused frequency-axis roformer block, one launch, at eval (K3) and as the
// training forward (B6):
//   y1  = x + drop(W_out (gate * softmax(rope(q) rope(k)^T / sqrt(32)) v)),
//   out = y1 + drop(W2 drop(gelu(W1 rmsnorm(y1) + b1)) + b2),
// where attention runs within each item of F consecutive rows (F frequency
// bins of one frame, F dividing 32).
//
// Replaces beat_this_tpu/ops/fused_freq.py:_fused_freq_kernel, reached
// through fused_freq_roformer -> _fused_freq_fwd_call: at dropout rate 0
// (eval, bt_fused_freq) and at rate > 0 (the training forward,
// bt_freq_train_fwd; its backward is fused_freq_train.cu). The TPU kernel
// packs 128 / F items into one masked 128-row score tile for its matrix
// unit; here 32 / F items share one 32 x 32 score tile with a
// block-diagonal mask, the size of two m16n8k16 fragments across (the
// tile's products and keep bits: small_tile.cuh, shared with B12).
//
// Bound on the H100: operations at C 64 and 128 (24 C^2 FLOPs a row in the
// four projections, against 2 C values of x and out), bytes at C 32 in
// bfloat16. The block stays one pass over the rows, so x is read once and
// out written once, and one launch a block keeps the eval forward's host
// work small (its busy share is low: PERF.md, section 5).
//
// Design (freq_block.cuh: freq_block_kernel, whose STAGE cuts are B13):
// a block of 8 warps takes a tile of 128 rows (16 per warp; tiles
// start on item boundaries, the last one masked). Every product runs on
// mma.sync m16n8k16 (bf16 operands, float32 accumulators; mma.cuh), each
// warp over its own 16 rows and all output columns, with float32 operands
// as P bf16 parts (tc_product.cuh): K3 takes two (three products, about 16
// bits, as K1 / K2), B6 three (six products, float32's 24 bits, as B7 / B8:
// the first training step's cancelling sums over rows need them). Shared
// memory holds x (then y1), one head's k and v and two weight slices:
//   1. x into a float32 tile; each row's norm and the gates sigmoid(g W_g +
//      b_g) from g = round_T(rmsnorm(x) gamma) and float32 W_g, in the
//      threads that hold the row's fragments. g itself is never stored: a
//      product's A fragments are formed from the tile as it runs.
//   2. per head: q, k, v = g W^T (one 32-column slice of W_qkv each), the
//      epilogue rounding to T, rotating q and k by RoPE at position row % F
//      and rounding again. q stays in registers as A fragments, k and v go
//      to shared memory as operands; then scores against the 32 keys of
//      the row's 32-row group (two warps), masked to the row's item, the
//      row's exact maximum in one pass (quad shuffles), p = exp2(s - m), l
//      over the unrounded p, in training p times its keep factor, round_T(p)
//      as the A fragments of P V, o = round_T(P V / l), go = round_T(o
//      gate), and at once go W_out^T for that head's 32 columns of W_out,
//      summed over the heads in registers;
//   3. y1 = x + drop(sum) in float32, over x in the tile;
//   4. the feed-forward in chunks of 32 hidden units: g2 = round_T(rmsnorm(
//      y1) gamma_ff) formed from the tile, h = round_T(drop(gelu(g2 W1^T +
//      b1))) kept in registers as A fragments, out += h W2^T in registers;
//      out = round_T(y1 + drop(out + b2)) through the tile, written once.
// The weights go through shared memory in slices of 32 C values (32 rows of
// W_qkv or W1, or 32 columns of W_out or W2), double-buffered: a slice is
// read into registers while the one before is in use, and float32 weights
// are split into bf16 parts as they are stored, so no conversion launch or
// cast precedes the kernel.
//
// The tile: 128 rows at every width and dtype. Forming g and g2 from the
// float32 tile and keeping q, the probabilities, go and h in registers
// leaves x (128 x (C + 8) floats), one head's k and v (P parts) and two
// weight slices in shared memory: 192 KB at C 128 in float32 training, the
// largest case (one block an SM), 46 KB at C 32 in bfloat16. Keeping g or a
// hidden chunk as P-part operands instead would not fit 128 rows at C 128.
//
// Rounding in bfloat16, where the TPU kernel rounds: g and g2, q, k, v after
// the product and again after RoPE, p before P V, o, go and h; the scores,
// l, y1 and the pre-activation stay float32. Dropout (B6) at the four sites
// under one salt, masks drawn from Philox by element coordinates (philox.cuh,
// ops/dropout.py): the probabilities at (item, head, query, key), a 4-key
// group drawn once for two lanes of a fragment; the attention output, FF
// hidden and FF output at (row of the (items F, C) view, column); items
// count from item0 and rows from row0 (= item0 F for a shard of a batch).
#include "freq_block.cuh"

namespace {

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

template <typename T> cudaError_t eval_blocks(int C, int* blocks) {
  switch (C) {
    case 32: return blocks_per_sm<32, T, false>(blocks);
    case 64: return blocks_per_sm<64, T, false>(blocks);
    case 128: return blocks_per_sm<128, T, false>(blocks);
    default: return cudaErrorInvalidValue;
  }
}

template <bool TRAIN>
int entry(int dtype, int C, const void* x, const void* agamma, const void* wqkv, const void* wg,
          const void* gb, const void* wout, const void* fgamma, const void* w1, const void* b1,
          const void* w2, const void* b2, const void* cosv, const void* sinv, void* out,
          long long rows, int F, int M, bt::Dropout drop, void* stream) {
  if (rows <= 0) return 0;
  if (F <= 0 || 32 % F || rows % F || M <= 0 || M % kNH) return (int)cudaErrorInvalidValue;
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
// (F, 16) are float32. x and out are (items * F, C); F divides 32; M % 32
// == 0.
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
                                 unsigned item0, unsigned row0, void* stream) {
  return entry<true>(dtype, C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv, sinv,
                     out, rows, F, M, bt::make_dropout(seed, salt, thr, scale, on, item0, row0),
                     stream);
}

// *blocks: the blocks of bt_fused_freq's launch (dtype, C as there) an SM
// holds; the ablation's cuts (freq_ablate.cu) are held to as many.
extern "C" int bt_fused_freq_blocks(int dtype, int C, int* blocks) {
  return (int)(dtype == 0   ? eval_blocks<float>(C, blocks)
               : dtype == 1 ? eval_blocks<__nv_bfloat16>(C, blocks)
                            : cudaErrorInvalidValue);
}
