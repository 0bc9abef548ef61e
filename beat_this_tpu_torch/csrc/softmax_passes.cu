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
// arithmetic rate). So the design keeps enough bytes in flight to near the
// memory's rate: one warp a row, 8 rows a 256-thread block, a block for
// every 8 rows (the hardware hands out the blocks as SMs free up, which
// keeps every SM busy to the end; a grid of resident blocks striding over
// the rows left SMs idle in its last rounds); a lane issues kVec 16-byte
// loads of its row before it uses any (a 1536-column row is all in flight
// at once), reduces them in registers and then across the warp by
// shuffles, and the warp writes the row's out_cols values as 16-byte
// stores. Loads and stores are streaming (evict-first: each byte is touched
// once). Rows whose start is not 16-byte aligned (cols not a multiple of 4)
// take one 4-byte load a lane and step.
#include "common.cuh"

namespace {

constexpr int kExp2 = 0, kRowMax = 1, kRowSum = 2;
constexpr int kWarps = bt::kThreads / 32;
constexpr int kVec = 12;  // 16-byte loads a lane has in flight

// A sum no input reaches: the exp2 of the columns that are not kept is added
// up and stored only if the sum equals it, so the compiler cannot drop that
// work (it could, were the store under a launch argument: it would test the
// argument first and skip the loads).
constexpr float kNever = 1.0e30f;

template <int OP> __device__ __forceinline__ float combine(float a, float b) {
  return OP == kRowMax ? fmaxf(a, b) : a + b;
}

template <int OP> __device__ __forceinline__ float identity() {
  return OP == kRowMax ? -INFINITY : 0.f;
}

// exp2 of the four columns from col (a float4 of the row) into dst, those
// below out_cols kept; the rest added to `unkept`.
__device__ __forceinline__ void exp2_quad(float4 v, int col, float* dst, int out_cols,
                                          bool vec_out, float& unkept) {
  const float e[4] = {exp2f(v.x), exp2f(v.y), exp2f(v.z), exp2f(v.w)};
  if (vec_out && col + 4 <= out_cols) {
    __stcs(reinterpret_cast<float4*>(dst + col), make_float4(e[0], e[1], e[2], e[3]));
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (col + i < out_cols)
      dst[col + i] = e[i];
    else
      unkept += e[i];
  }
}

template <int OP>
__global__ void __launch_bounds__(bt::kThreads)
    softmax_pass_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t rows,
                        int cols, int out_cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + warp;
  if (r >= rows) return;
  const bool vec_in = cols % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = out_cols % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const float* xr = x + r * cols;
  float* dst = out + r * out_cols;
  float a = identity<OP>(), unkept = 0.f;
  if (vec_in) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const int n4 = cols / 4;
    for (int c0 = 0; c0 < n4; c0 += 32 * kVec) {
      float4 v[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int c = c0 + 32 * u + lane;
        v[u] = c < n4 ? __ldcs(x4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int c = c0 + 32 * u + lane;
        if (c >= n4) continue;
        if constexpr (OP == kExp2) {
          exp2_quad(v[u], 4 * c, dst, out_cols, vec_out, unkept);
        } else {
          a = combine<OP>(a, combine<OP>(combine<OP>(v[u].x, v[u].y),
                                         combine<OP>(v[u].z, v[u].w)));
        }
      }
    }
  } else {
    for (int c = lane; c < cols; c += 32) {
      const float v = __ldcs(xr + c);
      if constexpr (OP == kExp2) {
        const float e = exp2f(v);
        if (c < out_cols)
          dst[c] = e;
        else
          unkept += e;
      } else {
        a = combine<OP>(a, v);
      }
    }
  }
  if constexpr (OP == kExp2) {
    if (unkept == kNever) dst[lane % out_cols] = unkept;
  } else {
#pragma unroll
    for (int o = 16; o; o >>= 1) a = combine<OP>(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (vec_out) {
      for (int c = lane; c < out_cols / 4; c += 32)
        __stcs(reinterpret_cast<float4*>(dst) + c, make_float4(a, a, a, a));
    } else {
      for (int c = lane; c < out_cols; c += 32) dst[c] = a;
    }
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
