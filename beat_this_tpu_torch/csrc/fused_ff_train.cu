// Feed-forward residual for training, forward (B8) and backward (B9):
//   out = x + drop_out(W2 drop_hid(gelu(W1 g + b1)) + b2),  g = rmsnorm(x) * gamma.
//
// Replaces beat_this_tpu/ops/fused_ff.py:_ff_train_kernel (forward, reached
// through _fused_ff_train) and :_ff_train_bwd_kernel (backward, through
// _fused_ff_train_bwd). The launches (both run every product on the tensor
// cores), their scratch layouts and what bounds them are in ff_train.cuh,
// shared with B7 (fused_freq_train.cu), whose FF half is B9's launches;
// here are the entry points, with the dropout masks under the FF salt.
#include "ff_train.cuh"

namespace {

using namespace ff;

// The backward's five fixed-order sums (db2, dgamma, db1, dW1, dW2), in one
// launch.
__global__ void __launch_bounds__(bt::kThreads) column_sums_kernel(SumJobs<5> s) {
  column_sums(s);
}

template <int C, typename T, typename X>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* w1, const void* b1,
                       const void* w2, const void* dout, void* dx, void* dgamma, void* dw1,
                       void* db1, void* dw2, void* db2, void* scratch, int64_t scratch_bytes,
                       int64_t rows, int M, int64_t group_rows, bt::Dropout drop,
                       cudaStream_t stream) {
  constexpr int P = std::is_same<T, float>::value ? 2 : 1;
  const BwdLayout s(scratch, P, rows, C, M, row_groups(rows, group_rows));
  if ((int64_t)s.bytes > scratch_bytes) return cudaErrorInvalidValue;
  cudaError_t err = bwd_launch<C, T, X, P>(s, (const X*)x, (const float*)gamma, (const T*)w1,
                                        (const float*)b1, (const T*)w2, (const T*)dout, (X*)dx,
                                        rows, M, group_rows, drop, stream);
  if (err != cudaSuccess) return err;
  SumJobs<5> sums;
  bwd_sums(s, C, M, (float*)dgamma, (float*)dw1, (float*)db1, (float*)dw2, (float*)db2, sums, 0);
  column_sums_kernel<<<sums.finish(), bt::kThreads, 0, stream>>>(sums);
  return cudaGetLastError();
}

template <int C, typename T>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, void* scratch,
                       int64_t scratch_bytes, int64_t rows, int M, bt::Dropout drop,
                       cudaStream_t stream) {
  // float32's own precision: the frontend's train-mode batch norms sum the
  // gradient behind each block over 96k-384k rows where it nearly cancels,
  // so the first training step's gradients hold the plain version's to 1e-3
  // only so (two parts missed it by up to 5.9x: PERF.md, Findings, PR 9)
  constexpr int P = full_parts<T>();
  const FwdLayout s(scratch, P, rows, C, M);
  if ((int64_t)s.bytes > scratch_bytes) return cudaErrorInvalidValue;
  ConvJobs conv;
  fwd_operands(conv, s, w1, w2, C, M);
  cudaError_t err = convert<T, P>(conv, stream);
  if (err != cudaSuccess) return err;
  return fwd_rows_launch<C, T, T, P>(s, (const T*)x, (const float*)gamma, (const float*)b1,
                                     (const float*)b2, (T*)out, rows, M, drop, stream);
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
                         const void* w2, const void* b2, void* out, void* scratch,
                         int64_t scratch_bytes, int64_t rows, int M, bt::Dropout drop,
                         cudaStream_t s) {
#define BT_CALL(CC)                                                                        \
  launch_fwd<CC, T>(x, gamma, w1, b1, w2, b2, out, scratch, scratch_bytes, rows, M, drop, s)
  BT_FF_SWITCH(BT_CALL)
#undef BT_CALL
}

template <typename T, typename X>
cudaError_t dispatch_bwd(int C, const void* x, const void* gamma, const void* w1, const void* b1,
                         const void* w2, const void* dout, void* dx, void* dgamma, void* dw1,
                         void* db1, void* dw2, void* db2, void* scratch, int64_t scratch_bytes,
                         int64_t rows, int M, int64_t group_rows, bt::Dropout drop,
                         cudaStream_t s) {
#define BT_CALL(CC)                                                                         \
  launch_bwd<CC, T, X>(x, gamma, w1, b1, w2, dout, dx, dgamma, dw1, db1, dw2, db2, scratch,  \
                    scratch_bytes, rows, M, group_rows, drop, s)
  BT_FF_SWITCH(BT_CALL)
#undef BT_CALL
}

}  // namespace

// Bytes of bt_ff_train_fwd's scratch for these arguments, in *bytes.
extern "C" int bt_ff_train_fwd_scratch(int dtype, int C, long long rows, int M,
                                       long long* bytes) {
  if ((dtype != 0 && dtype != 1) || rows < 0) return (int)cudaErrorInvalidValue;
  const int P = dtype == 0 ? full_parts<float>() : full_parts<__nv_bfloat16>();
  *bytes = (long long)FwdLayout(nullptr, P, rows, C, M).bytes;
  return 0;
}

// dtype: 0 float32, 1 bfloat16 (x, w1, w2, out); gamma, b1, b2 float32.
// x, out (rows, C); w1 (M, C); w2 (C, M); M % 64 == 0. scratch:
// scratch_bytes bytes, at least bt_ff_train_fwd_scratch's. Dropout: keep iff
// the Philox bits < thr, kept values times scale; on == 0 turns it off; the
// rows count from row0 (item0 is unused: no probability site).
extern "C" int bt_ff_train_fwd(int dtype, int C, const void* x, const void* gamma,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* out, void* scratch, long long scratch_bytes, long long rows,
                               int M, unsigned seed, unsigned salt, unsigned thr, float scale,
                               int on, unsigned item0, unsigned row0, void* stream) {
  if (rows <= 0) return 0;
  if (M % kHidN) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on, item0, row0);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? dispatch_fwd<float>(C, x, gamma, w1, b1, w2, b2, out, scratch,
                                                scratch_bytes, rows, M, d, s)
               : dtype == 1
                   ? dispatch_fwd<__nv_bfloat16>(C, x, gamma, w1, b1, w2, b2, out, scratch,
                                                 scratch_bytes, rows, M, d, s)
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
  *bytes = (long long)BwdLayout(nullptr, dtype == 0 ? 2 : 1, rows, C, M,
                                row_groups(rows, group_rows))
               .bytes;
  return 0;
}

// As bt_ff_train_fwd, plus dout (rows, C) in the dtype, dx (rows, C) in the
// type of x and float32 gradients dgamma (C), dw1 (M, C), db1 (M), dw2 (C, M),
// db2 (C). xdtype: x and dx in float32 (0) or the dtype (1; float32 x with
// bfloat16 compute is the frequency block's FF half). scratch: scratch_bytes
// bytes, at least bt_ff_train_bwd_scratch's; the weight-gradient products
// take the rows in groups of group_rows >= 1 (ops/fused_ff.py:
// ff_wgrad_split).
extern "C" int bt_ff_train_bwd(int dtype, int xdtype, int C, const void* x, const void* gamma,
                               const void* w1, const void* b1, const void* w2, const void* dout,
                               void* dx, void* dgamma, void* dw1, void* db1, void* dw2, void* db2,
                               void* scratch, long long scratch_bytes, long long rows, int M,
                               long long group_rows, unsigned seed, unsigned salt, unsigned thr,
                               float scale, int on, unsigned item0, unsigned row0, void* stream) {
  if (rows <= 0) return 0;
  if (M % kHidN || group_rows < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on, item0, row0);
  cudaStream_t s = (cudaStream_t)stream;
#define BT_DISPATCH(T, X)                                                                  \
  dispatch_bwd<T, X>(C, x, gamma, w1, b1, w2, dout, dx, dgamma, dw1, db1, dw2, db2, scratch, \
                     scratch_bytes, rows, M, group_rows, d, s)
  if (dtype == 0 && xdtype == 0) return (int)BT_DISPATCH(float, float);
  if (dtype == 1 && xdtype == 1) return (int)BT_DISPATCH(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 1 && xdtype == 0) return (int)BT_DISPATCH(__nv_bfloat16, float);
#undef BT_DISPATCH
  return (int)cudaErrorInvalidValue;
}
