// The packed small-attention tile on the tensor cores, shared by the
// frequency block's forward (fused_freq.cu: K3, B6) and the small-sequence
// attention kernels (small_attention.cu: B12): a warp's 16 queries against
// the NK = 16 or 32 keys of their row group, where the group starts on an
// item boundary and holds NK / F whole items of F rows (F dividing NK), so
// the score tile is block-diagonal and masked to each row's item. Operands
// are bf16 in shared memory, read by ldmatrix, with P parts `lo` elements
// apart (tc_product.cuh: P = 1 is bf16 itself, float32 splits into two or
// three parts); mma.sync m16n8k16 with float32 accumulators (mma.cuh),
// each product over parts by mm::mma_parts. Also the keep bits of the
// probability site (bt::kSiteAttnProbs) in the tile's C fragments.
#pragma once

#include "attn_tc.cuh"
#include "tc_product.cuh"

namespace {
namespace st {

using bf16 = __nv_bfloat16;

// Register r of A fragment a as P bf16 parts of (v0, v1): part 0 rounded to
// nearest even (round_T for bf16), each next part what the ones before leave.
template <int P>
__device__ __forceinline__ void set_parts(uint32_t (&a)[P][4], int r, float v0, float v1) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a[p][r] = bt::pack_bf16(v0, v1);
    if (p + 1 < P) {
      const float2 h = bt::unpack_bf16(a[p][r]);
      v0 -= h.x;
      v1 -= h.y;
    }
  }
}

// The A fragments (16 x 16 steps, P parts) of the 16 x (16 NK) matrix whose
// C fragments (8-column groups) are s.
template <int P, int NK>
__device__ __forceinline__ void frags_to_a(uint32_t (&a)[P][NK][4], const float (&s)[2 * NK][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t r[P][4];
    set_parts<P>(r, 0, s[2 * kk][0], s[2 * kk][1]);
    set_parts<P>(r, 1, s[2 * kk][2], s[2 * kk][3]);
    set_parts<P>(r, 2, s[2 * kk + 1][0], s[2 * kk + 1][1]);
    set_parts<P>(r, 3, s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[p][kk][i] = r[p][i];
  }
}

// A fragments (P parts `lo` apart) of rows r0 .. r0 + 15, depth k0 .. k0 +
// 15, of the row-major operand x (row stride ld).
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&a)[P][4], const bf16* x, int lo, int ld, int r0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p)
    bt::ldsm_x4(a[p], x + p * lo + (r0 + (lane & 15)) * ld + k0 + 8 * (lane >> 4));
}

// The same of the transpose of x: A's rows m0 .. m0 + 15 are columns of x,
// its depth k0 .. k0 + 15 rows of x.
template <int P>
__device__ __forceinline__ void load_at(uint32_t (&a)[P][4], const bf16* x, int lo, int ld, int m0,
                                        int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p)
    bt::ldsm_x4_t(a[p], x + p * lo + (k0 + (lane & 7) + 8 * (lane >> 4)) * ld + m0 +
                            8 * ((lane >> 3) & 1));
}

// c0, c1 += a times rows 16 np .. 16 np + 15 of the [n][k] operand w (P parts
// `lo` apart, row stride ldb), depth k0 .. k0 + 15, transposed.
template <int P>
__device__ __forceinline__ void mma_nt(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[P][4],
                                       const bf16* w, int lo, int ldb, int np, int k0) {
  const int lane = threadIdx.x & 31;
  uint32_t b[P][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
    bt::ldsm_x4(b[p], w + p * lo + (16 * np + 8 * (lane >> 4) + (lane & 7)) * ldb + k0 +
                          8 * ((lane >> 3) & 1));
  uint32_t b00[P], b01[P], b10[P], b11[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    b00[p] = b[p][0];
    b01[p] = b[p][1];
    b10[p] = b[p][2];
    b11[p] = b[p][3];
  }
  mm::mma_parts<P>(c0, a, b00, b01);
  mm::mma_parts<P>(c1, a, b10, b11);
}

// c0, c1 (columns n0 .. n0 + 7 and n0 + 8 .. n0 + 15) += a times rows k0 ..
// k0 + 15 of the [k][n] operand w (P parts `lo` apart, row stride ldb).
template <int P>
__device__ __forceinline__ void mma_nn(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[P][4],
                                       const bf16* w, int lo, int ldb, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  uint32_t b[P][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
    bt::ldsm_x4_t(b[p], w + p * lo + (k0 + 8 * ((lane >> 3) & 1) + (lane & 7)) * ldb + n0 +
                            8 * (lane >> 4));
  uint32_t b00[P], b01[P], b10[P], b11[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    b00[p] = b[p][0];
    b01[p] = b[p][1];
    b10[p] = b[p][2];
    b11[p] = b[p][3];
  }
  mm::mma_parts<P>(c0, a, b00, b01);
  mm::mma_parts<P>(c1, a, b10, b11);
}

// The query (relative to the group's first row) whose Philox groups this
// lane draws in prob_bits, for the warp's first query qb: the even lane of a
// pair row g, the odd lane row g + 8.
__device__ __forceinline__ int draw_row(int qb) {
  const int lane = threadIdx.x & 31;
  return qb + (lane >> 2) + 8 * (lane & 1);
}

// The keep bits of this lane's scores in the warp's 16 x NK tile: rows qb +
// g and qb + g + 8 of the group, keys 8 j + 2 t + e of the group; bit 2 j + e
// of bits[hh]. A 4-key group spans lanes t = 2 u and 2 u + 1: the even lane
// draws row g's, the odd lane row g + 8's (ql = draw_row(qb), of the item
// with Philox coordinates (item, head)), only where the group holds keys of
// the row's item, and they trade by one shuffle. Philox counter (key / 4,
// query, item, site << 16 | head) as ops/dropout.py; for F < 4 the row's one
// group is drawn and its first F keys are used. Every lane must call it.
template <int NK>
__device__ __forceinline__ void prob_bits(const bt::Dropout& d, int ql, uint32_t item,
                                          uint32_t head, int F, uint32_t (&bits)[2]) {
  const int lane = threadIdx.x & 31, t = lane & 3, odd = t & 1, u = t >> 1;
  const int first = ql - ql % F;
  const uint32_t query = (uint32_t)(ql % F);
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    const int key0 = 8 * j + 4 * u;
    const bool need = F >= 4 ? key0 / F == ql / F : key0 == (ql & ~3);
    if (need) {
      const uint4 b = bt::philox4x32_10(
          make_uint4(F >= 4 ? (uint32_t)(key0 - first) >> 2 : 0u, query, item,
                     (bt::kSiteAttnProbs << 16) | head),
          d.seed, d.salt);
      uint32_t m4 = (uint32_t)(b.x < d.thr) | ((uint32_t)(b.y < d.thr) << 1) |
                    ((uint32_t)(b.z < d.thr) << 2) | ((uint32_t)(b.w < d.thr) << 3);
      if (F < 4) m4 = (m4 & ((1u << F) - 1u)) << (first - key0);  // keys of the item only
      mine |= m4 << (4 * j);
    }
  }
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
  // this lane's two keys are elements 2 odd and 2 odd + 1 of each group
  const uint32_t r0 = (odd ? other : mine) >> (2 * odd), r1 = (odd ? mine : other) >> (2 * odd);
  bits[0] = bits[1] = 0u;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    bits[0] |= ((r0 >> (4 * j)) & 3u) << (2 * j);
    bits[1] |= ((r1 >> (4 * j)) & 3u) << (2 * j);
  }
}

}  // namespace st
}  // namespace
