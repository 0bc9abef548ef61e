// One softmax pass alone over a (rows, cols) float32 array:
//   exp2    out[r, c] = exp2(x[r, c]) for c < out_cols; exp2 is taken of
//           every element, only the first out_cols columns are kept
//   rowmax  out[r, :] = max over the row, in each of out_cols columns
//   rowsum  out[r, :] = sum over the row, in each of out_cols columns
//
// Replaces tools/bench_softmax_variants.py:build_vpu (`kern`), a Pallas body
// over row blocks of 512 that measures what a pass costs when its operand
// comes from device memory instead of staying in a fused kernel.
//
// Bound on the H100: bytes (rows * cols * 4 read, rows * out_cols * 4
// written; one exp2 or one compare or add per element is far below the
// arithmetic rate). One warp per row, 8 rows per 256-thread block: a warp
// reads its row in coalesced 128-byte steps, reduces with shuffles and
// writes the row's out_cols values coalesced.
#include "common.cuh"

namespace {

constexpr int kExp2 = 0, kRowMax = 1, kRowSum = 2;
constexpr int kWarps = bt::kThreads / 32;

// A sum no input reaches: the exp2 of the columns that are not kept is added
// up and stored only if the sum equals it, so the compiler cannot drop that
// work (it could, were the store under a launch argument: it would test the
// argument first and skip the loads).
constexpr float kNever = 1.0e30f;

template <int OP>
__global__ void __launch_bounds__(bt::kThreads)
    softmax_pass_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t rows,
                        int cols, int out_cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + warp;
  if (r >= rows) return;
  const float* xr = x + r * cols;
  float* dst = out + r * out_cols;
  if constexpr (OP == kExp2) {
    float unkept = 0.f;
    for (int c = lane; c < cols; c += 32) {
      const float e = exp2f(xr[c]);
      if (c < out_cols)
        dst[c] = e;
      else
        unkept += e;
    }
    if (unkept == kNever) dst[lane % out_cols] = unkept;
  } else {
    float a = OP == kRowMax ? -INFINITY : 0.f;
    for (int c = lane; c < cols; c += 32) a = OP == kRowMax ? fmaxf(a, xr[c]) : a + xr[c];
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float b = __shfl_xor_sync(0xffffffffu, a, o);
      a = OP == kRowMax ? fmaxf(a, b) : a + b;
    }
    for (int c = lane; c < out_cols; c += 32) dst[c] = a;
  }
}

template <int OP>
cudaError_t launch(const void* x, void* out, int64_t rows, int cols, int out_cols,
                   cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  softmax_pass_kernel<OP><<<blocks, bt::kThreads, 0, stream>>>((const float*)x, (float*)out, rows,
                                                               cols, out_cols);
  return cudaGetLastError();
}

}  // namespace

// x (rows, cols) and out (rows, out_cols) float32, 1 <= out_cols <= cols.
// op: 0 exp2, 1 rowmax, 2 rowsum.
extern "C" int bt_softmax_pass(int op, const void* x, void* out, long long rows, int cols,
                               int out_cols, void* stream) {
  if (rows <= 0) return 0;
  if (cols < 1 || out_cols < 1 || out_cols > cols) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kExp2: return (int)launch<kExp2>(x, out, rows, cols, out_cols, s);
    case kRowMax: return (int)launch<kRowMax>(x, out, rows, cols, out_cols, s);
    case kRowSum: return (int)launch<kRowSum>(x, out, rows, cols, out_cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
