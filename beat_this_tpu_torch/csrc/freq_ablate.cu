// The frequency block's SIMT design cut off after a stage, to see which stage
// its time went to:
//   copy  out = x                                    (the tile's round trip)
//   rms   out = round_T(rmsnorm(x) * gamma)
//   qkv   out = the first C columns (q before the rotation) of
//               round_T(W_qkv round_T(rmsnorm(x) * gamma)); the k and v
//               columns are computed and not kept
//   attn  out = x + W_out (gate * softmax(rope(q) rope(k)^T / sqrt(32)) v)
//   ff    out = x + FF(x), the feed-forward residual without the attention
//   full  the block itself: the launch of bt_fused_freq, unchanged
//
// Replaces tools/bench_fused_freq_ablate.py:make_kernel, a Pallas body that
// returns early after each stage on the grid and blocking of the real TPU
// kernel. Here every stage but `full` keeps the grid (one 256-thread block
// per 32-row tile), the shared-memory layout and the device code
// (freq_attn.cuh, common.cuh: float32 FMAs, weights streamed 16 inputs at a
// time) of the eval block as it was before it moved onto the tensor cores.
// `full` launches that block as it is now (fused_freq.cu: 128-row tiles,
// mma.sync), so the differences between the other stages add up to the SIMT
// design's time, not to `full`'s. `copy` and `rms` are no streaming kernels:
// a tile goes through shared memory at the SIMT design's low occupancy, and
// what they show is that floor.
//
// Bound on the H100: copy and rms move 2 * rows * C values and are bound by
// bytes; qkv, attn, ff by arithmetic at C = 128 (6 C^2, 8 C^2 + 4 F C and
// 16 C^2 FLOP per row) and by bytes at C = 32 in bfloat16.
#include "freq_attn.cuh"

extern "C" int bt_fused_freq(int dtype, int C, const void* x, const void* agamma,
                             const void* wqkv, const void* wg, const void* gb, const void* wout,
                             const void* fgamma, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* cosv, const void* sinv, void* out,
                             long long rows, int F, int M, void* stream);

namespace {

constexpr int kCopy = 0, kRms = 1, kQkv = 2, kFF = 3, kAttn = 4, kFull = 5;

// A sum no input reaches: the qkv stage adds up the k and v products it does
// not write and stores the sum only if it equals this, so the compiler
// cannot drop them.
constexpr float kNever = 1.0e30f;

template <int C, typename T, int STAGE>
__global__ void __launch_bounds__(bt::kThreads)
    freq_ablate_kernel(const T* __restrict__ x, const float* __restrict__ agamma,
                       const T* __restrict__ wqkv, const float* __restrict__ wg,
                       const float* __restrict__ gb, const T* __restrict__ wout,
                       const float* __restrict__ fgamma, const T* __restrict__ w1,
                       const float* __restrict__ b1, const T* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ cosv,
                       const float* __restrict__ sinv, T* __restrict__ out, int64_t rows, int F,
                       int M, float qscale) {
  constexpr int ld = bt::tile_ld(C);
  extern __shared__ float smem[];
  // the layout of fused_freq_kernel
  float* y = smem;
  float* scratch = y + bt::kRows * ld;
  float* g = scratch;
  float* ws = scratch + bt::kRows * ld + bt::kRows * (bt::kHid + 1);
  float* qkv = scratch + bt::ff_tail_floats<C>();
  float* gate = qkv + bt::kRows * (3 * C + 1);
  const int64_t row0 = (int64_t)blockIdx.x * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);

  bt::load_rows<C, T>(x, y, row0, nrows);
  if constexpr (STAGE == kCopy) {
    bt::store_rows<T>(y, ld, C, out, row0, nrows);
  } else if constexpr (STAGE == kFF) {
    bt::ff_tail<C, T>(y, scratch, fgamma, w1, b1, w2, b2, M, out, row0, nrows);
  } else {
    bt::rms_rows<C, true, T>(y, g, ld, agamma);
    if constexpr (STAGE == kRms) {
      bt::store_rows<T>(g, ld, C, out, row0, nrows);
    } else if constexpr (STAGE == kQkv) {
      const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
      float unkept = 0.f;
      for (int n0 = 0; n0 < 3 * C; n0 += C) {
        float acc[2][C / 16];
        bt::zero(acc);
        bt::mm_acc<C, T>(acc, g, ld, wqkv, C, n0, C, ws);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rg + 16 * i;
#pragma unroll
          for (int j = 0; j < C / 16; ++j) {
            if (n0 > 0)  // k and v: computed, not kept
              unkept += acc[i][j];
            else if (r < nrows)
              out[(row0 + r) * C + 2 * cp + 32 * (j / 2) + (j & 1)] = bt::from_f<T>(acc[i][j]);
          }
        }
      }
      if (unkept == kNever) out[row0 * C] = bt::from_f<T>(unkept);
    } else {
      static_assert(STAGE == kAttn, "stages: copy, rms, qkv, ff, attn (full is bt_fused_freq)");
      bt::freq_attention<C, T>(y, g, qkv, gate, ws, wqkv, wg, gb, wout, cosv, sinv, F, qscale);
      bt::store_rows<T>(y, ld, C, out, row0, nrows);
    }
  }
}

template <int C, typename T, int STAGE>
cudaError_t launch(const void* x, const void* agamma, const void* wqkv, const void* wg,
                   const void* gb, const void* wout, const void* fgamma, const void* w1,
                   const void* b1, const void* w2, const void* b2, const void* cosv,
                   const void* sinv, void* out, int64_t rows, int F, int M,
                   cudaStream_t stream) {
  constexpr size_t smem = bt::freq_smem_bytes<C>();
  auto kernel = freq_ablate_kernel<C, T, STAGE>;
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

template <int C, typename T>
cudaError_t by_stage(int stage, const void* x, const void* agamma, const void* wqkv,
                     const void* wg, const void* gb, const void* wout, const void* fgamma,
                     const void* w1, const void* b1, const void* w2, const void* b2,
                     const void* cosv, const void* sinv, void* out, int64_t rows, int F, int M,
                     cudaStream_t s) {
#define BT_CALL(SS)                                                                           \
  launch<C, T, SS>(x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv, sinv, out, rows, \
                   F, M, s)
  switch (stage) {
    case kCopy: return BT_CALL(kCopy);
    case kRms: return BT_CALL(kRms);
    case kQkv: return BT_CALL(kQkv);
    case kFF: return BT_CALL(kFF);
    case kAttn: return BT_CALL(kAttn);
    default: return cudaErrorInvalidValue;
  }
#undef BT_CALL
}

template <typename T>
cudaError_t by_width(int C, int stage, const void* x, const void* agamma, const void* wqkv,
                     const void* wg, const void* gb, const void* wout, const void* fgamma,
                     const void* w1, const void* b1, const void* w2, const void* b2,
                     const void* cosv, const void* sinv, void* out, int64_t rows, int F, int M,
                     cudaStream_t s) {
#define BT_CALL(CC)                                                                            \
  by_stage<CC, T>(stage, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv, sinv, out, \
                  rows, F, M, s)
  switch (C) {
    case 32: return BT_CALL(32);
    case 64: return BT_CALL(64);
    case 128: return BT_CALL(128);
    default: return cudaErrorInvalidValue;
  }
#undef BT_CALL
}

}  // namespace

// The arguments of bt_fused_freq plus `stage`: 0 copy, 1 rms, 2 qkv, 3 ff,
// 4 attn, 5 full (which is bt_fused_freq itself).
extern "C" int bt_freq_ablate(int dtype, int C, int stage, const void* x, const void* agamma,
                              const void* wqkv, const void* wg, const void* gb, const void* wout,
                              const void* fgamma, const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* cosv, const void* sinv, void* out,
                              long long rows, int F, int M, void* stream) {
  if (stage == kFull)
    return bt_fused_freq(dtype, C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv,
                         sinv, out, rows, F, M, stream);
  if (rows <= 0) return 0;
  if (F <= 0 || bt::kRows % F || rows % F || M % bt::kHid) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0 ? by_width<float>(C, stage, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2,
                                   cosv, sinv, out, rows, F, M, s)
      : dtype == 1
          ? by_width<__nv_bfloat16>(C, stage, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2,
                                    b2, cosv, sinv, out, rows, F, M, s)
          : cudaErrorInvalidValue;
  return (int)err;
}
