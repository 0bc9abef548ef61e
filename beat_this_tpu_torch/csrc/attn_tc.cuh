// The warp-level attention tile of the tensor-core attention kernels
// (flash_attention.cu: B10, B11, B14; fused_time_train.cu: B4, B5;
// fused_time.cu: K2; softmax_variants.cu: B15a; its quad reductions also in
// fused_freq.cu: K3, B6): a
// block of 4 warps, each owning 16 rows (queries, or keys in a key-major
// pass) whose operand fragments stay in registers, over 64-row tiles of the
// other side staged by cp.async through a 3-deep ring in shared memory and
// read by ldmatrix; mma.sync m16n8k16 with bf16 operands and float32
// accumulators (mma.cuh). An operand has P bf16 parts (tc_product.cuh): P = 1
// is bf16 itself, float32 takes two (a_lo b_hi + a_hi b_lo + a_hi b_hi, about
// 16 significant bits) or three (the six products of parts i, j with i + j
// <= 2, each k-step summed into fresh accumulators: float32's 24 bits). Also
// the dropout bits of the probability site (bt::kSiteAttnProbs, coordinates
// (key / 4, query, item, head)) in C fragments and as a key-major bit table,
// and the softmax scales of a head width (bt::scale, bt::qscale: the flash
// and small-sequence attention kernels').
#pragma once

#include "common.cuh"
#include "mma.cuh"
#include "tc_product.cuh"

namespace bt {

// D^-0.5 and D^-0.5 * log2(e), each rounded once to float32
template <int D> __host__ __device__ constexpr double scale_of() {
  static_assert(D == 16 || D == 32, "head widths 16 and 32 are instantiated");
  return D == 16 ? 0.25 : 0.17677669529663688;
}
template <int D> __host__ __device__ constexpr float scale() { return (float)scale_of<D>(); }
template <int D> __host__ __device__ constexpr float qscale() {
  return (float)(scale_of<D>() * 1.4426950408889634);
}

}  // namespace bt

namespace {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // queries (dkv: keys) per block, 16 per warp
constexpr int kTile = 64;      // keys (dkv: queries) per staged tile
constexpr int kStages = 3;     // staged tiles in flight

// A staged tile: 64 rows of D bf16 at a row stride of D + 8, so that the 8
// rows an ldmatrix reads at one column fall in 8 different bank groups.
template <int D> using Tile = bf16[kTile][D + 8];

// Element pair e (elements 2e, 2e + 1) of a float32 or bf16 array as float2,
// and a pair stored at p, rounded to the array's type.
__device__ __forceinline__ float2 load_pair(const float* p, int64_t e) {
  return reinterpret_cast<const float2*>(p)[e];
}
__device__ __forceinline__ float2 load_pair(const bf16* p, int64_t e) {
  return bt::unpack_bf16(reinterpret_cast<const uint32_t*>(p)[e]);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = bt::pack_bf16(a, b);
}

// Rows [r0, r0 + kTile) of the (n, D) matrix `src` into `dst` by cp.async,
// zeros past n.
template <int D>
__device__ __forceinline__ void stage(Tile<D>& dst, const bf16* __restrict__ src, int r0, int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = r0 + r < n;
    bt::cp_async16(&dst[r][8 * c], src + (size_t)(ok ? r0 + r : 0) * D + 8 * c, ok);
  }
}

// The same for a matrix whose rows lie `ld` elements apart (a head's column
// slice of a wider matrix).
template <int D>
__device__ __forceinline__ void stage_strided(Tile<D>& dst, const bf16* __restrict__ src,
                                              int64_t ld, int r0, int n) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = r0 + r < n;
    bt::cp_async16(&dst[r][8 * c], src + (ok ? (r0 + r) * ld : 0) + 8 * c, ok);
  }
}

// A fragments (per 16-channel step) of rows row0 .. row0 + 15 of the (n, D)
// matrix `src`, zeros past n, straight from global memory.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* __restrict__ src,
                                       int row0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(src + (size_t)(r < n ? r : 0) * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      a[kk][h] = r < n ? p[8 * kk + t] : 0u;
      a[kk][2 + h] = r < n ? p[8 * kk + 4 + t] : 0u;
    }
  }
}

// s[j] += the warp's 16 rows (A fragments a) times rows 8j .. 8j + 7 of
// `tile`, transposed: the 16 x 64 products of the warp's rows with the
// tile's rows, as C fragments.
template <int D>
__device__ __forceinline__ void product_nt_acc(float (&s)[8][4], const uint32_t (&a)[D / 16][4],
                                               const Tile<D>& tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      bt::ldsm_x4(b, &tile[16 * p + 8 * (lane >> 4) + (lane & 7)][16 * kk + 8 * ((lane >> 3) & 1)]);
      bt::mma_bf16(s[2 * p], a[kk], b[0], b[1]);
      bt::mma_bf16(s[2 * p + 1], a[kk], b[2], b[3]);
    }
}

template <int N> __device__ __forceinline__ void zero_frags(float (&s)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
}

// s[j] = the same products (product_nt_acc from zero).
template <int D>
__device__ __forceinline__ void product_nt(float (&s)[8][4], const uint32_t (&a)[D / 16][4],
                                           const Tile<D>& tile) {
  zero_frags(s);
  product_nt_acc<D>(s, a, tile);
}

// acc[c] (channels 8c .. 8c + 7) += P (16 x 64, A fragments pa[kk] over
// tile rows 16kk .. 16kk + 15) times `tile` (64 x D).
template <int D>
__device__ __forceinline__ void product_nn(float (&acc)[D / 8][4], const uint32_t (&pa)[4][4],
                                           const Tile<D>& tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      uint32_t b[4];
      bt::ldsm_x4_t(b, &tile[16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)][16 * c + 8 * (lane >> 4)]);
      bt::mma_bf16(acc[2 * c], pa[kk], b[0], b[1]);
      bt::mma_bf16(acc[2 * c + 1], pa[kk], b[2], b[3]);
    }
}

// The A fragments of the 16 x 64 matrix whose C fragments are s, each value
// rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t (&pa)[4][4], const float (&s)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = bt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = bt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = bt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = bt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// -- operands of P parts ---------------------------------------------------------

// Rows [r0, r0 + kTile) of the (n, D) matrix `src` into the P tiles `tl`,
// one per operand part (`lo` elements apart).
template <int D, int P>
__device__ __forceinline__ void stage_parts(Tile<D>* tl, const bf16* __restrict__ src, int64_t lo,
                                            int r0, int n) {
#pragma unroll
  for (int p = 0; p < P; ++p) stage<D>(tl[p], src + p * lo, r0, n);
}

template <int D, int P>
__device__ __forceinline__ void load_parts(uint32_t (&a)[P][D / 16][4],
                                           const bf16* __restrict__ src, int64_t lo, int row0,
                                           int n) {
#pragma unroll
  for (int p = 0; p < P; ++p) load_a<D>(a[p], src + p * lo, row0, n);
}

// s = the warp's 16 rows (parts a) times the tile's 64 rows (parts tl),
// transposed. Two parts: a_lo t_hi + a_hi t_lo, then a_hi t_hi; three: per
// k-step mm::mma_parts (the small terms and a_0 t_0 in fresh accumulators).
template <int D, int P>
__device__ __forceinline__ void scores(float (&s)[8][4], const uint32_t (&a)[P][D / 16][4],
                                       const Tile<D>* tl) {
  zero_frags(s);
  if constexpr (P == 3) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[P][4], b0[P], b1[P], b2[P], b3[P];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          bt::ldsm_x4(b[q], &tl[q][16 * p + 8 * (lane >> 4) + (lane & 7)]
                                  [16 * kk + 8 * ((lane >> 3) & 1)]);
          b0[q] = b[q][0];
          b1[q] = b[q][1];
          b2[q] = b[q][2];
          b3[q] = b[q][3];
        }
        uint32_t ak[P][4];
#pragma unroll
        for (int q = 0; q < P; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) ak[q][r] = a[q][kk][r];
        mm::mma_parts<P>(s[2 * p], ak, b0, b1);
        mm::mma_parts<P>(s[2 * p + 1], ak, b2, b3);
      }
  } else {
    if constexpr (P == 2) {
      product_nt_acc<D>(s, a[1], tl[0]);
      product_nt_acc<D>(s, a[0], tl[1]);
    }
    product_nt_acc<D>(s, a[0], tl[0]);
  }
}

// acc += the 16 x 64 matrix (parts pa) times the tile (parts tl), in the
// order of `scores`.
template <int D, int P>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const uint32_t (&pa)[P][4][4],
                                           const Tile<D>* tl) {
  if constexpr (P == 3) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t b[P][4], b0[P], b1[P], b2[P], b3[P];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          bt::ldsm_x4_t(b[q], &tl[q][16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)]
                                    [16 * c + 8 * (lane >> 4)]);
          b0[q] = b[q][0];
          b1[q] = b[q][1];
          b2[q] = b[q][2];
          b3[q] = b[q][3];
        }
        uint32_t ak[P][4];
#pragma unroll
        for (int q = 0; q < P; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) ak[q][r] = pa[q][kk][r];
        mm::mma_parts<P>(acc[2 * c], ak, b0, b1);
        mm::mma_parts<P>(acc[2 * c + 1], ak, b2, b3);
      }
  } else {
    if constexpr (P == 2) {
      product_nn<D>(acc, pa[1], tl[0]);
      product_nn<D>(acc, pa[0], tl[1]);
    }
    product_nn<D>(acc, pa[0], tl[0]);
  }
}

// The A fragments of the C fragments s as P bf16 parts: round(s), then what
// the parts before leave, rounded.
template <int P>
__device__ __forceinline__ void to_parts(uint32_t (&pa)[P][4][4], const float (&s)[8][4]) {
  to_a(pa[0], s);
  if constexpr (P > 1) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* x = &s[2 * kk + (r >> 1)][2 * (r & 1)];
        const float2 h = bt::unpack_bf16(pa[0][kk][r]);
        float r0 = x[0] - h.x, r1 = x[1] - h.y;
        pa[1][kk][r] = bt::pack_bf16(r0, r1);
        if constexpr (P == 3) {
          const float2 h1 = bt::unpack_bf16(pa[1][kk][r]);
          r0 -= h1.x;
          r1 -= h1.y;
          pa[2][kk][r] = bt::pack_bf16(r0, r1);
        }
      }
  }
}

// Bytes of dynamic shared memory of a query-major pass (K and V rings) and
// of a key-major pass (Q and dO rings, the rows' m or lse and delta, two
// mask tables).
template <int D, int P> constexpr size_t fwd_smem() { return 2 * kStages * P * sizeof(Tile<D>); }
template <int D, int P> constexpr size_t dkv_smem() {
  return fwd_smem<D, P>() + 2 * kStages * kTile * sizeof(float) + 2 * kTile * (kRows / 4);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Keep bits of the thread's scores in a 16 x 64 (query, key) tile: rows
// `row` and row + 8 (queries), keys k0 + 8j + 2t + e; bits[h] bit 2j + e is
// row h's. A 4-key Philox group spans lanes t = 2u and 2u + 1: the even
// lane draws row `row`'s groups, the odd lane row + 8's, and they trade by
// one shuffle. Every lane of the warp must call it.
__device__ __forceinline__ void keep_bits(const bt::Dropout& d, uint32_t item, uint32_t head,
                                          int row, int k0, uint32_t (&bits)[2]) {
  const int t = threadIdx.x & 3, odd = t & 1;
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 b = bt::philox4x32_10(
        make_uint4((uint32_t)(k0 >> 2) + 2 * j + (t >> 1), (uint32_t)(row + 8 * odd),
                   item + d.item0, (bt::kSiteAttnProbs << 16) | head),
        d.seed, d.salt);
    mine |= (uint32_t)((b.x < d.thr) | ((b.y < d.thr) << 1) | ((b.z < d.thr) << 2) |
                       ((b.w < d.thr) << 3)) << (4 * j);
  }
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
  // this lane's two keys are elements 2 odd and 2 odd + 1 of each group
  const uint32_t r0 = (odd ? other : mine) >> (2 * odd), r1 = (odd ? mine : other) >> (2 * odd);
  bits[0] = bits[1] = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bits[0] |= ((r0 >> (4 * j)) & 3u) << (2 * j);
    bits[1] |= ((r1 >> (4 * j)) & 3u) << (2 * j);
  }
}

__device__ __forceinline__ float keep_factor(const bt::Dropout& d, uint32_t bits, int bit) {
  return ((bits >> bit) & 1u) ? d.scale : 0.f;
}

// 2^x by the MUFU unit, results below 2^-126 flushed to zero (p that
// small is zero at bf16's precision of the sums it enters)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The Philox bits of query rows q0 .. q0 + kTile - 1 by the block's 64
// keys from kb0, one byte per 4-key group.
__device__ __forceinline__ void keep_table(uint8_t (&keepb)[kTile][kRows / 4],
                                           const bt::Dropout& d, uint32_t item, uint32_t head,
                                           int kb0, int q0) {
  for (int e = threadIdx.x; e < kTile * (kRows / 4); e += kThreads) {
    const int i = e / (kRows / 4), kg = e % (kRows / 4);
    const uint4 b = bt::philox4x32_10(
        make_uint4((kb0 >> 2) + kg, q0 + i, item + d.item0, (bt::kSiteAttnProbs << 16) | head),
        d.seed, d.salt);
    keepb[i][kg] = (uint8_t)((b.x < d.thr) | ((b.y < d.thr) << 1) | ((b.z < d.thr) << 2) |
                             ((b.w < d.thr) << 3));
  }
}

}  // namespace tc
}  // namespace
