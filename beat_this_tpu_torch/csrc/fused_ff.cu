// Fused feed-forward residual (eval, K1): out = x + W2 gelu(W1 rmsnorm(x) + b1) + b2.
//
// Replaces beat_this_tpu/ops/fused_ff.py:_ff_kernel (reached through
// fused_ff), the eval feed-forward residual that the short-piece path runs
// in every time block and main layer, and the head_dim 16 model in every
// block. It is the training forward's function at dropout rate 0, so it
// runs that forward's launches (ff_train.cuh, B8) with dropout off, which
// draw no Philox bits and write no masks: the weight operands W1^T and
// W2^T from the float32 weights (converted on every call: a weight may
// change between calls), a row pass for g = round_T(rmsnorm(x) gamma), the
// hidden product with b1 and the exact GELU in its epilogue (h rounded once
// to T), and the output product with b2 and x added in float32, rounded
// once (at small row counts in depth slices and a summing pass). Every
// product runs on the tensor cores (mma.sync m16n8k16, bf16 operands,
// float32 accumulators) over 128-row tiles, in a 2-D grid of (hidden or
// output column tiles) x (row tiles); float32 as three bf16 products of
// two-part operands (about 16 significant bits; B8 takes three parts for
// the cancelling sums of training, which eval does not have).
//
// Bound on the H100: arithmetic at C 512 (4 C M FLOPs a row, M = 4 C,
// against 2 C values read and written); at C 32-128 the bytes of x, out and
// the hidden layer's operand.
#include "ff_train.cuh"

namespace {

template <int C, typename T>
cudaError_t launch(const void* x, const void* gamma, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, void* scratch,
                   int64_t scratch_bytes, int64_t rows, int M, cudaStream_t stream) {
  constexpr int P = mm::split_parts<T>();
  const ff::FwdLayout s(scratch, P, rows, C, M);
  if ((int64_t)s.bytes > scratch_bytes) return cudaErrorInvalidValue;
  mm::ConvJobs conv;
  ff::fwd_operands(conv, s, w1, w2, C, M);
  cudaError_t err = mm::convert<float, P>(conv, stream);
  if (err != cudaSuccess) return err;
  return ff::fwd_rows_launch<C, T, T, P>(s, (const T*)x, (const float*)gamma, (const float*)b1,
                                         (const float*)b2, (T*)out, rows, M, bt::Dropout{},
                                         stream);
}

template <typename T>
cudaError_t dispatch(int C, const void* x, const void* gamma, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* out, void* scratch,
                     int64_t scratch_bytes, int64_t rows, int M, cudaStream_t s) {
#define BT_CALL(CC) \
  case CC: return launch<CC, T>(x, gamma, w1, b1, w2, b2, out, scratch, scratch_bytes, rows, M, s);
  switch (C) {
    BT_CALL(32)
    BT_CALL(64)
    BT_CALL(128)
    BT_CALL(256)
    BT_CALL(384)
    BT_CALL(512)
    default: return cudaErrorInvalidValue;
  }
#undef BT_CALL
}

}  // namespace

extern "C" const char* bt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Bytes of bt_fused_ff's scratch for these arguments, in *bytes.
extern "C" int bt_fused_ff_scratch(int dtype, int C, long long rows, int M, long long* bytes) {
  if ((dtype != 0 && dtype != 1) || rows < 0 || M % ff::kHidN) return (int)cudaErrorInvalidValue;
  *bytes = (long long)ff::FwdLayout(nullptr, dtype == 0 ? 2 : 1, rows, C, M).bytes;
  return 0;
}

// dtype: 0 float32, 1 bfloat16 (x, out); the weights w1 (M, C), w2 (C, M),
// gamma, b1 and b2 float32 (the kernel rounds the weights to the dtype's
// operands). x, out (rows, C); M % 64 == 0. scratch: scratch_bytes bytes,
// at least bt_fused_ff_scratch's.
extern "C" int bt_fused_ff(int dtype, int C, const void* x, const void* gamma, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out,
                           void* scratch, long long scratch_bytes, long long rows, int M,
                           void* stream) {
  if (rows <= 0) return 0;
  if (M % ff::kHidN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0 ? dispatch<float>(C, x, gamma, w1, b1, w2, b2, out, scratch, scratch_bytes,
                                   rows, M, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(C, x, gamma, w1, b1, w2, b2, out, scratch,
                                             scratch_bytes, rows, M, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
