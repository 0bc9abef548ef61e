// Fused time-axis roformer block (eval, K2):
//   y1  = x + W_out (gate * softmax(rope(q) rope(k)^T / sqrt(32)) v),
//   out = y1 + FF(y1),
// with q, k, v = W_qkv rmsnorm(x) and gate = sigmoid(W_g rmsnorm(x) + b_g)
// per head.
//
// Replaces beat_this_tpu/ops/fused_time.py:_kernel (reached through
// fused_time_roformer), which runs the whole block for one sequence in one
// program with a full 1536 x 1536 float32 score tile in VMEM. Such a tile is
// 9.4 MB, about forty times a block's shared memory, and blocks here run in
// parallel, so the block is a chain of 8 launches with O(rows C)
// intermediates in device memory, every product on the tensor cores
// (mma.sync m16n8k16, bf16 operands, float32 accumulators; tc_product.cuh,
// attn_tc.cuh):
//   1. operands: W_qkv^T, W_out^T, W1^T and W2^T as bf16 operands from the
//      float32 weights, in one launch (converted on every call: a weight may
//      change between calls);
//   2. rows and 3. qkv (time_qkv.cuh, shared with the training forward B4):
//      g and the gates from the float32 normed rows, then g W_qkv^T with
//      RoPE in the epilogue, q, k, v written as the attention's operands;
//   4. attn (time_attn.cuh): B4's attention core at rate 0, writing only
//      round_T(o * gate) as the out projection's operand;
//   5. out: go W_out^T; the epilogue adds x in float32 and keeps y1 in
//      float32, as the TPU kernel does (fused_time.py:195, :205);
//   6-8. the feed-forward residual on y1 (ff_train.cuh: B8's row pass,
//      hidden and output launches at rate 0, float32 rows), out rounded once
//      (9 launches where the output product is taken in depth slices).
// float32 runs every product as three bf16 products of two-part operands
// (a_lo b_hi + a_hi b_lo + a_hi b_hi, about 16 significant bits; the block
// has none of the cancelling sums over rows that made the training kernels
// B7 / B8 take three parts).
//
// Rounding in bf16, where the TPU kernel rounds: the normed rows before the
// q/k/v product (the gates take them unrounded), q, k, v after RoPE, p
// before P V, the gated head output, the FF's normed rows and its hidden
// layer h once before W2; y1 and the FF's pre-activation stay float32. The
// plain version (ops/fused_time.py:fused_time_roformer_ref) rounds after
// each torch op, y1 included, and sums the softmax over unrounded scores;
// each such difference is one bf16 rounding (2^-9 relative) of a term, far
// inside the bf16 limit of 2.5e-2 (PERF.md, section 2).
//
// Bound on the H100: the products, 24 C^2 + 4 n C FLOPs a row (q/k/v, out,
// W1, W2; scores and P V), against a few C values of each row read and
// written; the scratch operands are O(rows C).
#include "ff_train.cuh"
#include "time_attn.cuh"
#include "time_qkv.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mm::kTM;
using mm::Operand;

// y1 = x + go W_out^T in float32 (A: go, B: W_out^T, operands of P parts).
template <int BN, typename T, int P>
__global__ void __launch_bounds__(bt::kThreads)
    time_out_kernel(Operand A, Operand B, const T* __restrict__ x, float* __restrict__ y1,
                    int64_t rows, int C) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int64_t m0 = (int64_t)blockIdx.y * kTM;
  const int n0 = blockIdx.x * BN;
  float acc[2][BN / 16][4];
  mm::product<false, BN, P>(acc, A, B, m0, n0, 0, C, rows, C, reinterpret_cast<bf16*>(smem_b));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp & 3), wn = (BN / 2) * (warp >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t r = m0 + wm + 16 * mi + (lane >> 2) + 8 * hh;
        const int col = n0 + wn + 8 * j + 2 * (lane & 3);
        if (r >= rows || col >= C) continue;
        const int64_t at = r * C + col;
        *reinterpret_cast<float2*>(y1 + at) = make_float2(
            bt::to_f(x[at]) + acc[mi][j][2 * hh], bt::to_f(x[at + 1]) + acc[mi][j][2 * hh + 1]);
      }
}

// The scratch (on a null base: its size alone): the FF's layout (g, which
// the attention's g shares, h1d, W1^T, W2^T; operands of P parts), then
// W_qkv^T (P 3C C), W_out^T (P C C), q, k, v (P rows C each), the gated
// attention output go (P rows C), as bf16 operands, and the float32 gates
// (rows C / 32) and y1 (rows C).
struct EvalLayout {
  ff::FwdLayout ff;
  bf16 *wqkv, *wout, *qkv, *go;
  float *gates, *y1;
  size_t bytes;

  EvalLayout(void* base, int P, int64_t rows, int C, int M) : ff(base, P, rows, C, M) {
    mm::Carver c(base);
    c.bytes = ff.bytes;
    wqkv = c.take<bf16>((int64_t)P * 3 * C * C);
    wout = c.take<bf16>((int64_t)P * C * C);
    qkv = c.take<bf16>(P * 3 * rows * C);
    go = c.take<bf16>(P * rows * C);
    gates = c.take<float>(rows * (C / tq::kHD));
    y1 = c.take<float>(rows * C);
    bytes = c.bytes;
  }
};

template <int C, typename T>
cudaError_t launch(const void* x, const void* agamma, const void* wqkv, const void* wg,
                   const void* gb, const void* wout, const void* fgamma, const void* w1,
                   const void* b1, const void* w2, const void* b2, const void* cosv,
                   const void* sinv, void* out, void* scratch, int64_t scratch_bytes, int items,
                   int n, int M, cudaStream_t stream) {
  constexpr int H = C / tq::kHD, P = mm::split_parts<T>(), BN = mm::product_n(C);
  const int64_t rows = (int64_t)items * n, rlo = rows * C;
  const EvalLayout s(scratch, P, rows, C, M);
  if ((int64_t)s.bytes > scratch_bytes) return cudaErrorInvalidValue;
  const bt::Dropout off{};

  mm::ConvJobs conv;
  conv.add(wqkv, s.wqkv, 3 * C, C, 1);
  conv.add(wout, s.wout, C, C, 1);
  ff::fwd_operands(conv, s.ff, w1, w2, C, M);
  cudaError_t err = mm::convert<float, P>(conv, stream);
  if (err != cudaSuccess) return err;

  err = tq::qkv_launch<C, T, P, P>((const T*)x, (const float*)agamma,
                                   Operand{s.wqkv, 3 * C, (int64_t)3 * C * C}, (const float*)wg,
                                   (const float*)gb, (const float*)cosv, (const float*)sinv,
                                   s.ff.g, s.gates, nullptr, nullptr, nullptr, s.qkv, rows, n,
                                   stream);
  if (err != cudaSuccess) return err;

  auto ka = tc::attn_fwd_kernel<P, true>;
  if ((err = bt::allow_smem(ka, tc::fwd_smem<tq::kHD, P>())) != cudaSuccess) return err;
  ka<<<dim3(items * H, (n + tc::kRows - 1) / tc::kRows), tc::kThreads, tc::fwd_smem<tq::kHD, P>(),
       stream>>>(s.qkv, s.qkv + P * rlo, s.qkv + 2 * P * rlo, rlo, s.gates, nullptr, s.go, rlo,
                 nullptr, nullptr, n, H, off);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto ko = time_out_kernel<BN, T, P>;
  const size_t smem_out = mm::product_smem<false, BN, P>();
  if ((err = bt::allow_smem(ko, smem_out)) != cudaSuccess) return err;
  ko<<<dim3((C + BN - 1) / BN, (unsigned)((rows + kTM - 1) / kTM)), bt::kThreads, smem_out,
       stream>>>(Operand{s.go, C, rlo}, Operand{s.wout, C, (int64_t)C * C}, (const T*)x, s.y1,
                 rows, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  return ff::fwd_rows_launch<C, T, float, P>(s.ff, s.y1, (const float*)fgamma, (const float*)b1,
                                             (const float*)b2, (T*)out, rows, M, off, stream);
}

template <typename T>
cudaError_t dispatch(int C, const void* x, const void* agamma, const void* wqkv, const void* wg,
                     const void* gb, const void* wout, const void* fgamma, const void* w1,
                     const void* b1, const void* w2, const void* b2, const void* cosv,
                     const void* sinv, void* out, void* scratch, int64_t scratch_bytes,
                     int items, int n, int M, cudaStream_t s) {
#define BT_TIME_CASE(CC)                                                                       \
  case CC:                                                                                     \
    return launch<CC, T>(x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv, sinv, out, \
                         scratch, scratch_bytes, items, n, M, s);
  switch (C) {
    BT_TIME_CASE(32)
    BT_TIME_CASE(64)
    BT_TIME_CASE(128)
    BT_TIME_CASE(256)
    BT_TIME_CASE(384)
    BT_TIME_CASE(512)
    default: return cudaErrorInvalidValue;
  }
#undef BT_TIME_CASE
}

bool supported(int C) {
  return C == 32 || C == 64 || C == 128 || C == 256 || C == 384 || C == 512;
}

}  // namespace

// Bytes of bt_fused_time's scratch over rows = items * n rows, in *bytes.
extern "C" int bt_fused_time_scratch(int dtype, int C, long long rows, int M, long long* bytes) {
  if ((dtype != 0 && dtype != 1) || !supported(C) || rows < 0 || M % ff::kHidN)
    return (int)cudaErrorInvalidValue;
  *bytes = (long long)EvalLayout(nullptr, dtype == 0 ? 2 : 1, rows, C, M).bytes;
  return 0;
}

// dtype: 0 float32, 1 bfloat16 for x and out (items, n, C); the weights
// wqkv (3C, C), wout (C, C), w1 (M, C), w2 (C, M) (the kernel rounds them to
// the dtype's operands), agamma, wg (C/32, C), gb, fgamma, b1, b2 and
// cos/sin (n, 16) are float32. M % 64 == 0. scratch: scratch_bytes bytes,
// at least bt_fused_time_scratch's.
extern "C" int bt_fused_time(int dtype, int C, const void* x, const void* agamma,
                             const void* wqkv, const void* wg, const void* gb, const void* wout,
                             const void* fgamma, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* cosv, const void* sinv, void* out,
                             void* scratch, long long scratch_bytes, int items, int n, int M,
                             void* stream) {
  if (items <= 0 || n <= 0) return 0;
  if (M % ff::kHidN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0 ? dispatch<float>(C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2,
                                   cosv, sinv, out, scratch, scratch_bytes, items, n, M, s)
      : dtype == 1
          ? dispatch<__nv_bfloat16>(C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2,
                                    cosv, sinv, out, scratch, scratch_bytes, items, n, M, s)
          : cudaErrorInvalidValue;
  return (int)err;
}
