// The packed small-attention tile on the tensor cores, shared by the
// frequency block's forward (fused_freq.cu: K3, B6), the small-sequence
// attention kernels (small_attention.cu: B12) and the frequency block's
// training backward's attention core (freq_core.cu: B7): a warp's 16
// queries against the NK = 16 or 32 keys of their row group, where the
// group starts on an item boundary and holds NK / F whole items of F rows
// (F dividing NK), so the score tile is block-diagonal and masked to each
// row's item. Operands are bf16 in shared memory, read by ldmatrix, with P
// parts `lo` elements apart (tc_product.cuh: P = 1 is bf16 itself, float32
// splits into two or three parts); mma.sync m16n8k16 with float32
// accumulators (mma.cuh), each product over parts by mm::mma_parts. Also
// the keep bits of the probability site (bt::kSiteAttnProbs) in the tile's
// C fragments, and the 64-row blocks of B12 and B7's core: coalesced
// 16-byte loads of a block's rows, their bf16 parts in shared memory, the
// score tile's probabilities and results out through shared memory.
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
          make_uint4(F >= 4 ? (uint32_t)(key0 - first) >> 2 : 0u, query, item + d.item0,
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

// -- 64-row blocks of 4 warps (B12, B7's core) ---------------------------------

constexpr int kWarps = 4;
constexpr int kNT = 32 * kWarps;  // threads per block
constexpr int kTM = 16 * kWarps;  // rows per block

// A tile of kTM rows of N values as P bf16 parts: part p of row r at r LD +
// p LO. LD is an odd number of 16-byte units, so the 8 rows an ldmatrix
// reads fall in 8 different bank groups.
template <int N, int P> struct Rows {
  static constexpr int LO = N + 8;
  static constexpr int LD = P * LO + (P % 2 ? 0 : 8);
  static constexpr int ELEMS = kTM * LD;
};

// The keys of a warp's score tile: the 16 rows of its own items, or the 32
// of the item its rows belong to.
template <int F> constexpr int kKeys = F <= 16 ? 16 : 32;

// A block's rows of D columns of a row-major tensor of T (row stride ld) in
// 16-byte chunks, N a thread: chunk i of this thread at tile row row(i),
// columns col(i) .. + PER - 1.
template <int D, typename T> struct Chunks {
  static constexpr int PER = 16 / sizeof(T);
  static constexpr int ROW = D / PER;  // chunks per row
  static constexpr int N = kTM * ROW / kNT;
  static_assert(N * kNT == kTM * ROW, "a block's chunks spread evenly over its threads");
  uint4 c[N];

  __device__ __forceinline__ static int row(int i) { return (threadIdx.x + i * kNT) / ROW; }
  __device__ __forceinline__ static int col(int i) { return (threadIdx.x + i * kNT) % ROW * PER; }

  // zeros past nrows
  __device__ __forceinline__ void load(const T* __restrict__ src, int64_t ld, int64_t row0,
                                       int nrows) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      c[i] = row(i) < nrows
                 ? __ldg(reinterpret_cast<const uint4*>(src + (row0 + row(i)) * ld + col(i)))
                 : make_uint4(0u, 0u, 0u, 0u);
  }

  __device__ __forceinline__ void values(int i, float (&x)[PER]) const {
    if constexpr (sizeof(T) == 4) {
      x[0] = __uint_as_float(c[i].x);
      x[1] = __uint_as_float(c[i].y);
      x[2] = __uint_as_float(c[i].z);
      x[3] = __uint_as_float(c[i].w);
    } else {
      const uint32_t w[4] = {c[i].x, c[i].y, c[i].z, c[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = bt::unpack_bf16(w[e]);
        x[2 * e] = f.x;
        x[2 * e + 1] = f.y;
      }
    }
  }
};

// The rotation of the pairs in columns col .. col + 2 H - 1 of a row at
// position pos: cos and sin, 1 and 0 without tables.
template <int D, int H> struct Angles {
  float cs[H], sn[H];

  __device__ __forceinline__ Angles(const float* __restrict__ cosv,
                                    const float* __restrict__ sinv, int pos, int col) {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int at = pos * (D / 2) + col / 2 + i;
      cs[i] = cosv == nullptr ? 1.f : __ldg(cosv + at);
      sn[i] = cosv == nullptr ? 0.f : __ldg(sinv + at);
    }
  }

  // x rotated by RoPE
  __device__ __forceinline__ void rotate(float (&x)[2 * H]) const {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float a = x[2 * i], b = x[2 * i + 1];
      x[2 * i] = a * cs[i] - b * sn[i];
      x[2 * i + 1] = b * cs[i] + a * sn[i];
    }
  }
};

// round_T(x mul) as P bf16 parts at dst, `lo` apart.
template <typename T, int P, int PER>
__device__ __forceinline__ void put(bf16* dst, int lo, const float (&x)[PER], float mul = 1.f) {
  float r[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) r[e] = bt::round_to<T>(x[e] * mul);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    uint32_t w[PER / 2];
#pragma unroll
    for (int e = 0; e < PER / 2; ++e) {
      w[e] = bt::pack_bf16(r[2 * e], r[2 * e + 1]);
      if (p + 1 < P) {
        const float2 h = bt::unpack_bf16(w[e]);
        r[2 * e] -= h.x;
        r[2 * e + 1] -= h.y;
      }
    }
    if constexpr (PER == 4)
      *reinterpret_cast<uint2*>(dst + p * lo) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint4*>(dst + p * lo) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The C fragments o of the warp's 16 rows out through `stage` (the warp's
// own shared memory, row stride sd) to rows row0 .. row0 + nrows - 1 (at
// most 16) of dst (row stride ld), 16 bytes a lane and store.
template <int D, typename T>
__device__ __forceinline__ void write_rows(T* __restrict__ dst, int64_t ld, T* stage, int sd,
                                           int64_t row0, int nrows, const float (&o)[D / 8][4]) {
  constexpr int PER = 16 / sizeof(T), ROW = D / PER;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();  // the warp is done reading what `stage` held
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      T* p = stage + (g + 8 * hh) * sd + 8 * j + 2 * t;
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(p) = make_float2(o[j][2 * hh], o[j][2 * hh + 1]);
      else
        *reinterpret_cast<uint32_t*>(p) = bt::pack_bf16(o[j][2 * hh], o[j][2 * hh + 1]);
    }
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * ROW; e += 32) {
    const int r = e / ROW, c = e % ROW * PER;
    if (r < nrows)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * ld + c) =
          *reinterpret_cast<const uint4*>(stage + r * sd + c);
  }
}

// g (the warp's rows r0 + g, r0 + g + 8 at positions row % F; columns 8 j +
// 2 t, + 1) pulled back through the rotation (its transpose) times `mul`,
// rounded to T.
template <int F, int D, typename T>
__device__ __forceinline__ void pull_back(float (&x)[D / 8][4], int r0,
                                          const float* __restrict__ cosv,
                                          const float* __restrict__ sinv, float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pos = (r0 + g + 8 * hh) % F;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int at = pos * (D / 2) + 4 * j + t;
      const float cs = cosv == nullptr ? 1.f : __ldg(cosv + at);
      const float sn = cosv == nullptr ? 0.f : __ldg(sinv + at);
      const float a = x[j][2 * hh], b = x[j][2 * hh + 1];
      x[j][2 * hh] = bt::round_to<T>((a * cs + b * sn) * mul);
      x[j][2 * hh + 1] = bt::round_to<T>((b * cs - a * sn) * mul);
    }
  }
}

// The warp's 16 x NK probabilities: s = Q K^T over the group (queries from
// row rw of qs, keys from row grp of ks), times `mul` (SCALED), masked to
// each row's item; s becomes exp2(s - m), zero off the item, and l the
// rows' sums over the quad (the warp's rows start qb rows into the group).
template <int F, int D, int P, bool SCALED = false>
__device__ __forceinline__ void probabilities(float (&s)[kKeys<F> / 8][4], float (&l)[2],
                                              const bf16* qs, const bf16* ks, int rw, int grp,
                                              float mul = 1.f) {
  using R = Rows<D, P>;
  constexpr int NK = kKeys<F>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, qb = rw - grp;
  tc::zero_frags(s);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[P][4];
    load_a<P>(a, qs, R::LO, R::LD, rw, 16 * kk);
#pragma unroll
    for (int np = 0; np < NK / 16; ++np)
      mma_nt<P>(s[2 * np], s[2 * np + 1], a, ks + grp * R::LD, R::LO, R::LD, np, 16 * kk);
  }
  if constexpr (SCALED)
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= mul;
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if ((8 * j + 2 * t + e) / F == (qb + g + 8 * hh) / F)
          m[hh] = fmaxf(m[hh], s[j][2 * hh + e]);
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = tc::quad_max(m[hh]);
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = (8 * j + 2 * t + e) / F == (qb + g + 8 * hh) / F;
        const float p = in ? tc::fast_exp2(s[j][2 * hh + e] - m[hh]) : 0.f;
        l[hh] += p;
        s[j][2 * hh + e] = p;
      }
    l[hh] = tc::quad_sum(l[hh]);
  }
}

// The keep factors' bits of the warp's scores (prob_bits), all set without
// dropout, for the group whose first row is row grow0 of the tensor; item e
// = row / F of the rows at Philox (e / heads, e % heads + head0).
template <int F>
__device__ __forceinline__ void keep_bits(const bt::Dropout& drop, int64_t grow0, int qb,
                                          int heads, int head0, uint32_t (&bits)[2]) {
  bits[0] = bits[1] = ~0u;
  if (!drop.on) return;
  const int ql = draw_row(qb);
  const int64_t e = (grow0 + ql) / F;
  prob_bits<kKeys<F>>(drop, ql, (uint32_t)(e / heads), (uint32_t)(e % heads + head0), F, bits);
}

__device__ __forceinline__ float keep_factor(const bt::Dropout& drop, uint32_t bits, int bit) {
  return !drop.on ? 1.f : ((bits >> bit) & 1u) ? drop.scale : 0.f;
}

// k-step kk's A fragments (P parts) out of a tile's (frags_to_a).
template <int P, int NKS>
__device__ __forceinline__ void kstep(uint32_t (&ak)[P][4], const uint32_t (&a)[P][NKS][4],
                                      int kk) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) ak[p][i] = a[p][kk][i];
}

}  // namespace st
}  // namespace
