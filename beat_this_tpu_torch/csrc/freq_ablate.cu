// The frequency block's eval kernel cut off after a stage, to see which stage
// its time goes to:
//   copy  out = x                                    (the tile's round trip)
//   rms   out = round_T(rmsnorm(x) * gamma)
//   qkv   out = the first C columns (q before the rotation) of
//               round_T(W_qkv round_T(rmsnorm(x) * gamma)); the k and v
//               columns are computed and not kept
//   ff    out = x + FF(x), the feed-forward residual without the attention
//   attn  out = x + W_out (gate * softmax(rope(q) rope(k)^T / sqrt(32)) v)
//   full  the block itself: the launch of bt_fused_freq, unchanged
//
// Replaces tools/bench_fused_freq_ablate.py:make_kernel, a Pallas body that
// returns early after each stage on the grid and blocking of the real TPU
// kernel. Here, by the same rule, every cut is the block's own kernel
// (freq_block.cuh: freq_block_kernel with its STAGE argument, the code of
// K3 up to the cut): the same grid of 128-row tiles and 8 warps as `full`
// and its blocks per SM (its shared-memory size, raised for a cut whose
// fewer registers would let more blocks share an SM: cut_smem), products on
// the tensor cores (float32 in two parts, as K3), weights staged in the same
// slices (only those the cut uses). So ff + attn - copy stands for full, and
// copy is the floor of K3's load and store at its occupancy.
//
// Bound on the H100: copy and rms move 2 * rows * C values and are bound by
// bytes; qkv, attn, ff by operations at C = 128 (6 C^2, 8 C^2 + 4 F C and
// 16 C^2 FLOP per row) and by bytes at C = 32 in bfloat16.
#include <type_traits>

#include "freq_block.cuh"

extern "C" int bt_fused_freq(int dtype, int C, const void* x, const void* agamma,
                             const void* wqkv, const void* wg, const void* gb, const void* wout,
                             const void* fgamma, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* cosv, const void* sinv, void* out,
                             long long rows, int F, int M, void* stream);
extern "C" int bt_fused_freq_blocks(int dtype, int C, int* blocks);

namespace {

template <int V> using Int = std::integral_constant<int, V>;
template <typename T> struct Type { using type = T; };

// fn(Type<T>{}, Int<C>{}, Int<STAGE>{}) for the cut `stage` at dtype and C.
template <typename Fn> cudaError_t on_cut(int dtype, int C, int stage, Fn fn) {
  auto by_stage = [&](auto t, auto c) -> cudaError_t {
    switch (stage) {
      case kCopy: return fn(t, c, Int<kCopy>{});
      case kRms: return fn(t, c, Int<kRms>{});
      case kQkv: return fn(t, c, Int<kQkv>{});
      case kFF: return fn(t, c, Int<kFF>{});
      case kAttn: return fn(t, c, Int<kAttn>{});
      default: return cudaErrorInvalidValue;
    }
  };
  auto by_width = [&](auto t) -> cudaError_t {
    switch (C) {
      case 32: return by_stage(t, Int<32>{});
      case 64: return by_stage(t, Int<64>{});
      case 128: return by_stage(t, Int<128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  return dtype == 0   ? by_width(Type<float>{})
         : dtype == 1 ? by_width(Type<__nv_bfloat16>{})
                      : cudaErrorInvalidValue;
}

// The dynamic shared memory of the cut STAGE and the blocks an SM then holds:
// the whole block's size, raised where the cut's fewer registers would let
// more of its blocks share an SM than the whole block's, until they do not.
// Kept per device (the first kDevices).
constexpr int kDevices = 16;

template <int C, typename T, int STAGE> cudaError_t cut_smem(size_t* smem, int* blocks) {
  static size_t kept_smem[kDevices];
  static int kept_blocks[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && kept_blocks[dev]) {
    *smem = kept_smem[dev];
    *blocks = kept_blocks[dev];
    return cudaSuccess;
  }
  int whole = 0, per_sm = 0, reserved = 0, most = 0;
  size_t bytes = Shape<C, T, false>::SMEM;
  err = (cudaError_t)bt_fused_freq_blocks(sizeof(T) == 4 ? 0 : 1, C, &whole);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = blocks_per_sm<C, T, false, STAGE>(blocks, bytes);
  if (err == cudaSuccess && *blocks > whole) {
    // whole + 1 blocks of this size, each with its reserve, overfill the SM
    const size_t over = ((size_t)(per_sm / (whole + 1) - reserved + 1) + 127) & ~(size_t)127;
    bytes = over > bytes ? over : bytes;
    while ((err = blocks_per_sm<C, T, false, STAGE>(blocks, bytes)) == cudaSuccess &&
           *blocks > whole && bytes + 1024 <= (size_t)most)
      bytes += 1024;
  }
  if (err != cudaSuccess) return err;
  *smem = bytes;
  if (dev < kDevices) {
    kept_smem[dev] = bytes;
    kept_blocks[dev] = *blocks;
  }
  return cudaSuccess;
}

}  // namespace

// The arguments of bt_fused_freq plus `stage`: 0 copy, 1 rms, 2 qkv, 3 ff,
// 4 attn, 5 full (which is bt_fused_freq itself).
extern "C" int bt_freq_ablate(int dtype, int C, int stage, const void* x, const void* agamma,
                              const void* wqkv, const void* wg, const void* gb, const void* wout,
                              const void* fgamma, const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* cosv, const void* sinv, void* out,
                              long long rows, int F, int M, void* stream) {
  if (stage == kWhole)
    return bt_fused_freq(dtype, C, x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv,
                         sinv, out, rows, F, M, stream);
  if (rows <= 0) return 0;
  if (F <= 0 || 32 % F || rows % F || M <= 0 || M % kNH) return (int)cudaErrorInvalidValue;
  return (int)on_cut(dtype, C, stage, [&](auto t, auto c, auto st) {
    using T = typename decltype(t)::type;
    size_t smem = 0;
    int blocks = 0;
    cudaError_t err = cut_smem<decltype(c)::value, T, decltype(st)::value>(&smem, &blocks);
    if (err != cudaSuccess) return err;
    return launch<decltype(c)::value, T, false, decltype(st)::value>(
        x, agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2, cosv, sinv, out, rows, F, M,
        bt::Dropout{}, (cudaStream_t)stream, smem);
  });
}

// *blocks: the blocks of stage's launch (codes as bt_freq_ablate) an SM holds
// at dtype and C; a cut holds as many as the whole block where its registers
// let it.
extern "C" int bt_freq_ablate_blocks(int dtype, int C, int stage, int* blocks) {
  if (stage == kWhole) return bt_fused_freq_blocks(dtype, C, blocks);
  return (int)on_cut(dtype, C, stage, [&](auto t, auto c, auto st) {
    size_t smem = 0;
    return cut_smem<decltype(c)::value, typename decltype(t)::type, decltype(st)::value>(
        &smem, blocks);
  });
}
