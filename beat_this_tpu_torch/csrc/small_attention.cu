// Exact-softmax attention over (items, F, D) for short sequences (F divides
// 32: the frontend's frequency axis, 32 / 16 / 8 bins), heads folded into
// the items, with the rotation of q and k inside, forward and backward:
//   o = drop_p(softmax(rope(q) rope(k)^T D^-0.5)) v     per item,
// the softmax in base 2 with D^-0.5 log2(e) folded into q before q is
// rounded, dropout on the probabilities from Philox (philox.cuh) by the
// coordinates (item / heads, item % heads, query, key), the normalizer
// summed over the undropped p.
//
// Replaces beat_this_tpu/ops/small_attention.py:_small_attn_kernel and
// :_small_attn_bwd_kernel, which pack 128 / F items into one masked
// 128 x 128 score matrix for the TPU's matrix unit. Here 16 / F items (F <=
// 16) or one item (F = 32) share a 16 x 16 or a 32 x 32 block-diagonal
// score tile (small_tile.cuh, the tile of K3 / B6), the size of one or two
// m16n8k16 fragments across, and every product runs on mma.sync (bf16
// operands, float32 accumulators; mma.cuh). Float32 operands are P bf16
// parts (tc_product.cuh: the products of parts i, j with i + j < P): the
// forward three (six products, float32's 24 bits: its 1e-5 limit, which two
// parts miss), the backward two (three products, about 16 bits, within its
// 1e-4); bfloat16 one (tests/test_torch_small_tc_design.py).
//
// Bound on the H100: bytes. Each of q, k, v, o (and dout, dq, dk, dv) is
// read or written once against 4 F D FLOPs per row forward, 10 F D
// backward: at most 23 FLOPs a byte (bfloat16 backward at F 32), where the
// tensor cores' rate would allow 295 (bfloat16) or ~98 (float32's split
// products). So the design keeps the loads and stores wide and many blocks
// resident:
//   - a block of 4 warps takes 64 rows (whole items; the last block masked,
//     rows past the end zero). Its threads read q, k, v (and dout) with
//     coalesced 16-byte loads into registers, all issued before any is used,
//     then rotate q and k at position row % F (float32 tables read through
//     L1), scale q by D^-0.5 log2(e), round to T where the plain version
//     rounds, split into P parts and store the tiles to shared memory (a
//     row's P parts side by side, rows an odd number of 16 bytes apart, so
//     an ldmatrix's 8 rows hit 8 bank groups). That is where cp.async would
//     put them raw: the conversion on the way saves a second copy;
//   - each warp owns 16 rows: as queries, S = Q K^T against its group's keys
//     (ldmatrix), masked to the row's item; the exact maximum by quad
//     shuffles; p = exp2(s - m) (MUFU), l over the unrounded p; in training p times
//     its keep factor; round_T(p) as the A fragments of P V (ldmatrix.trans
//     of V), o = round_T(P V / l);
//   - backward: S and p recomputed (nothing is saved by the forward), dp =
//     dO V^T, then the softmax's backward rounded where the plain version's
//     autograd rounds: pf = round_T(p f) (p unnormalized, P V's operand),
//     delta = sum pf dp / l, ds = round_T(ln2 (p / l) (f dp - delta)) (the
//     gradient of the base-2 scores); dq = ds K, pulled back through the
//     rotation times D^-0.5 log2(e); ds, pf and dout / l go to shared
//     memory, and each warp, as keys now, forms dk = ds^T Q (the scaled q)
//     and dv = pf^T (dout / l) of its own 16 keys (ldmatrix.trans of both
//     tiles; dv's operands in three parts in either dtype, as the plain
//     version takes that product in float32): every key's dk and dv from one
//     warp, no atomics, two runs give the same bits;
//   - results leave through shared memory as coalesced 16-byte stores, each
//     warp's 16 rows through its own rows of a tile no other warp reads (q's
//     forward, dout's backward); the keep bits are drawn while the block's
//     loads are in flight.
// Shared memory, the largest case (float32 backward at D 32, F 32): 85 KB,
// two blocks an SM; the forward 45 KB at most.
#include "small_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// bf16 parts of an operand: the forward's at float32's own precision, the
// backward's about 16 bits (tests/test_torch_small_tc_design.py).
// ln 2: the gradient of exp2.
constexpr float kLn2 = 0.6931471805599453f;
// Parts of dv's operands, round_T(p f) and dout / l, in both dtypes: the
// plain version takes that product in float32.
constexpr int kDvParts = 3;
template <typename T> constexpr int kFwdParts = mm::full_parts<T>();
template <typename T> constexpr int kBwdParts = mm::split_parts<T>();

// A block's rows of an (rows, D) tensor of T in 16-byte chunks, N a thread:
// chunk i of this thread at tile row row(i), columns col(i) .. + PER - 1.
template <int D, typename T> struct Chunks {
  static constexpr int PER = 16 / sizeof(T);
  static constexpr int ROW = D / PER;  // chunks per row
  static constexpr int N = kTM * ROW / kNT;
  static_assert(N * kNT == kTM * ROW, "a block's chunks spread evenly over its threads");
  uint4 c[N];

  __device__ __forceinline__ static int row(int i) { return (threadIdx.x + i * kNT) / ROW; }
  __device__ __forceinline__ static int col(int i) { return (threadIdx.x + i * kNT) % ROW * PER; }

  // zeros past nrows
  __device__ __forceinline__ void load(const T* __restrict__ src, int64_t row0, int nrows) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      c[i] = row(i) < nrows
                 ? __ldg(reinterpret_cast<const uint4*>(src + (row0 + row(i)) * D + col(i)))
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
// most 16) of dst, 16 bytes a lane and store.
template <int D, typename T>
__device__ __forceinline__ void write_rows(T* __restrict__ dst, T* stage, int sd, int64_t row0,
                                           int nrows, const float (&o)[D / 8][4]) {
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
      *reinterpret_cast<uint4*>(dst + (row0 + r) * D + c) =
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
// row rw of qs, keys from row grp of ks), masked to each row's item; s
// becomes exp2(s - m), zero off the item, and l the rows' sums over the
// quad (the warp's rows start qb rows into the group).
template <int F, int D, int P>
__device__ __forceinline__ void probabilities(float (&s)[kKeys<F> / 8][4], float (&l)[2],
                                              const bf16* qs, const bf16* ks, int rw, int grp) {
  using R = Rows<D, P>;
  constexpr int NK = kKeys<F>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, qb = rw - grp;
  tc::zero_frags(s);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[P][4];
    st::load_a<P>(a, qs, R::LO, R::LD, rw, 16 * kk);
#pragma unroll
    for (int np = 0; np < NK / 16; ++np)
      st::mma_nt<P>(s[2 * np], s[2 * np + 1], a, ks + grp * R::LD, R::LO, R::LD, np, 16 * kk);
  }
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
// dropout; item e of the rows at Philox (e / heads, e % heads).
template <int F>
__device__ __forceinline__ void keep_bits(const bt::Dropout& drop, int64_t grow0, int qb,
                                          int heads, uint32_t (&bits)[2]) {
  bits[0] = bits[1] = ~0u;
  if (!drop.on) return;
  const int ql = st::draw_row(qb);
  const int64_t e = (grow0 + ql) / F;
  st::prob_bits<kKeys<F>>(drop, ql, (uint32_t)(e / heads), (uint32_t)(e % heads), F, bits);
}

__device__ __forceinline__ float keep_factor(const bt::Dropout& drop, uint32_t bits, int bit) {
  return !drop.on ? 1.f : ((bits >> bit) & 1u) ? drop.scale : 0.f;
}

template <int F, int D, typename T>
__global__ void __launch_bounds__(kNT)
    small_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ cosv, const float* __restrict__ sinv,
                     T* __restrict__ o, int64_t rows, int heads, bt::Dropout drop) {
  constexpr int P = kFwdParts<T>, NK = kKeys<F>;
  using R = Rows<D, P>;
  using C = Chunks<D, T>;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* qs = reinterpret_cast<bf16*>(smem_b);  // then o, staged
  bf16* ks = qs + R::ELEMS;
  bf16* vs = ks + R::ELEMS;
  const int64_t row0 = (int64_t)blockIdx.x * kTM;
  const int nrows = (int)min((int64_t)kTM, rows - row0);
  const int rw = 16 * (threadIdx.x >> 5), grp = NK == 16 ? rw : rw & ~31;
  uint32_t bits[2];
  {
    C cq, ck, cv;
    cq.load(q, row0, nrows);
    ck.load(k, row0, nrows);
    cv.load(v, row0, nrows);
    keep_bits<F>(drop, row0 + grp, rw - grp, heads, bits);  // while the loads are in flight
#pragma unroll
    for (int i = 0; i < C::N; ++i) {
      const int r = C::row(i), c = C::col(i);
      const Angles<D, C::PER / 2> rope(cosv, sinv, r % F, c);
      float x[C::PER];
      cq.values(i, x);
      rope.rotate(x);
      put<T, P>(qs + r * R::LD + c, R::LO, x, bt::qscale<D>());
      ck.values(i, x);
      rope.rotate(x);
      put<T, P>(ks + r * R::LD + c, R::LO, x);
      cv.values(i, x);
      put<T, P>(vs + r * R::LD + c, R::LO, x);
    }
  }
  __syncthreads();

  float s[NK / 8][4], l[2];
  probabilities<F, D, P>(s, l, qs, ks, rw, grp);
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[j][2 * hh + e] *= keep_factor(drop, bits[hh], 2 * j + e);
  // o = round_T(round_T(p f) V / l)
  float acc[D / 8][4];
  tc::zero_frags(acc);
  {
    uint32_t pa[P][NK / 16][4];
    st::frags_to_a<P, NK / 16>(pa, s);
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t ak[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) ak[p][i] = pa[p][kk][i];
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        st::mma_nn<P>(acc[2 * c], acc[2 * c + 1], ak, vs + grp * R::LD, R::LO, R::LD, 16 * kk,
                      16 * c);
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[j][2 * hh + e] = bt::round_to<T>(acc[j][2 * hh + e] / l[hh]);
  // o leaves through the warp's own rows of q's tile, which no other warp reads
  constexpr int SD = D + C::PER;
  static_assert(sizeof(T) * SD <= sizeof(bf16) * R::LD, "a result row fits in a tile's row");
  write_rows<D, T>(o, reinterpret_cast<T*>(qs + rw * R::LD), SD, row0 + rw, nrows - rw, acc);
}

template <int F, int D, typename T>
__global__ void __launch_bounds__(kNT)
    small_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ cosv, const float* __restrict__ sinv,
                     const T* __restrict__ dout, T* __restrict__ dq_out, T* __restrict__ dk_out,
                     T* __restrict__ dv_out, int64_t rows, int heads, bt::Dropout drop) {
  constexpr int P = kBwdParts<T>, NK = kKeys<F>;
  using R = Rows<D, P>;
  using RK = Rows<NK, P>;
  using RV = Rows<D, kDvParts>;
  using RKV = Rows<NK, kDvParts>;
  using C = Chunks<D, T>;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* qs = reinterpret_cast<bf16*>(smem_b);  // q rotated, scaled, rounded
  bf16* ks = qs + R::ELEMS;
  bf16* vs = ks + R::ELEMS;
  bf16* dos = vs + R::ELEMS;     // dout; then the warp's results, staged
  bf16* dss = dos + R::ELEMS;    // ds, (query, key of the group)
  bf16* pfs = dss + RK::ELEMS;   // round_T(p f), p unnormalized
  bf16* dls = pfs + RKV::ELEMS;  // dout / l
  const int64_t row0 = (int64_t)blockIdx.x * kTM;
  const int nrows = (int)min((int64_t)kTM, rows - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int rw = 16 * warp, grp = NK == 16 ? rw : rw & ~31, qb = rw - grp;
  uint32_t bits[2];
  {
    C cq, ck, cv, cd;
    cq.load(q, row0, nrows);
    ck.load(k, row0, nrows);
    cv.load(v, row0, nrows);
    cd.load(dout, row0, nrows);
    keep_bits<F>(drop, row0 + grp, qb, heads, bits);  // while the loads are in flight
#pragma unroll
    for (int i = 0; i < C::N; ++i) {
      const int r = C::row(i), c = C::col(i);
      const Angles<D, C::PER / 2> rope(cosv, sinv, r % F, c);
      float x[C::PER];
      cq.values(i, x);
      rope.rotate(x);
      put<T, P>(qs + r * R::LD + c, R::LO, x, bt::qscale<D>());
      ck.values(i, x);
      rope.rotate(x);
      put<T, P>(ks + r * R::LD + c, R::LO, x);
      cv.values(i, x);
      put<T, P>(vs + r * R::LD + c, R::LO, x);
      cd.values(i, x);
      put<T, P>(dos + r * R::LD + c, R::LO, x);
    }
  }
  __syncthreads();

  // results leave through the warp's own rows of dout's tile, which no other
  // warp reads
  constexpr int SD = D + C::PER;
  static_assert(sizeof(T) * SD <= sizeof(bf16) * R::LD, "a result row fits in a tile's row");
  T* stage = reinterpret_cast<T*>(dos + rw * R::LD);
  {
    float s[NK / 8][4], l[2];
    probabilities<F, D, P>(s, l, qs, ks, rw, grp);
    // dp = dO V^T over the group's keys
    float dp[NK / 8][4];
    tc::zero_frags(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[P][4];
      st::load_a<P>(a, dos, R::LO, R::LD, rw, 16 * kk);
#pragma unroll
      for (int np = 0; np < NK / 16; ++np)
        st::mma_nt<P>(dp[2 * np], dp[2 * np + 1], a, vs + grp * R::LD, R::LO, R::LD, np,
                      16 * kk);
    }
    // the softmax's backward, rounded where the plain version's autograd
    // rounds: pf = round_T(p f) with p unnormalized (P V's operand), delta =
    // sum pf dp / l (dout . o before o is rounded), ds = round_T(ln2 (p / l)
    // (f dp - delta)) (the gradient of the base-2 scores); then pf into dp,
    // ds into s
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          delta[hh] += bt::round_to<T>(s[j][2 * hh + e] *
                                       keep_factor(drop, bits[hh], 2 * j + e)) *
                       dp[j][2 * hh + e];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) delta[hh] = tc::quad_sum(delta[hh]) / l[hh];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = s[j][2 * hh + e], f = keep_factor(drop, bits[hh], 2 * j + e);
          s[j][2 * hh + e] =
              bt::round_to<T>(kLn2 * (p / l[hh]) * (f * dp[j][2 * hh + e] - delta[hh]));
          dp[j][2 * hh + e] = bt::round_to<T>(p * f);
        }
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rw + g + 8 * hh;
        mm::store2<P>(dss + r * RK::LD + 8 * j + 2 * t, RK::LO, s[j][2 * hh], s[j][2 * hh + 1]);
        mm::store2<kDvParts>(pfs + r * RKV::LD + 8 * j + 2 * t, RKV::LO, dp[j][2 * hh],
                             dp[j][2 * hh + 1]);
      }
    // dout / l of the warp's rows, from dout as given (the plain version
    // divides the float32 cotangent)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rw + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        float x[2] = {0.f, 0.f};
        if (r < nrows) {
          const T* src = dout + (row0 + r) * D + 8 * j + 2 * t;
          x[0] = bt::to_f(src[0]) / l[hh];
          x[1] = bt::to_f(src[1]) / l[hh];
        }
        mm::store2<kDvParts>(dls + r * RV::LD + 8 * j + 2 * t, RV::LO, x[0], x[1]);
      }
    }
    // dq = ds K, pulled back through the rotation times D^-0.5 log2(e)
    float dq[D / 8][4];
    tc::zero_frags(dq);
    uint32_t da[P][NK / 16][4];
    st::frags_to_a<P, NK / 16>(da, s);
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t ak[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) ak[p][i] = da[p][kk][i];
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        st::mma_nn<P>(dq[2 * c], dq[2 * c + 1], ak, ks + grp * R::LD, R::LO, R::LD, 16 * kk,
                      16 * c);
    }
    pull_back<F, D, T>(dq, rw, cosv, sinv, bt::qscale<D>());
    write_rows<D, T>(dq_out, stage, SD, row0 + rw, nrows - rw, dq);
  }
  __syncthreads();  // ds, p f and dout / l of both warps of a group

  // the warp's rows as keys, sums over the group's queries: dk = ds^T Q (the
  // scaled q of the scores), dv = pf^T (dout / l)
  float dk[D / 8][4], dv[D / 8][4];
  tc::zero_frags(dk);
  tc::zero_frags(dv);
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[P][4];
    st::load_at<P>(a, dss + grp * RK::LD, RK::LO, RK::LD, qb, 16 * kk);
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      st::mma_nn<P>(dk[2 * c], dk[2 * c + 1], a, qs + grp * R::LD, R::LO, R::LD, 16 * kk, 16 * c);
    uint32_t av[kDvParts][4];
    st::load_at<kDvParts>(av, pfs + grp * RKV::LD, RKV::LO, RKV::LD, qb, 16 * kk);
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      st::mma_nn<kDvParts>(dv[2 * c], dv[2 * c + 1], av, dls + grp * RV::LD, RV::LO, RV::LD,
                           16 * kk, 16 * c);
  }
  pull_back<F, D, T>(dk, rw, cosv, sinv, 1.f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[j][e] = bt::round_to<T>(dv[j][e]);
  write_rows<D, T>(dk_out, stage, SD, row0 + rw, nrows - rw, dk);
  write_rows<D, T>(dv_out, stage, SD, row0 + rw, nrows - rw, dv);
}

// Shared-memory bytes of the forward (q, k, v tiles) and the backward (q, k,
// v, dout; ds; p f and dout / l in kDvParts parts).
template <int F, int D, typename T> constexpr size_t fwd_smem() {
  return sizeof(bf16) * 3 * Rows<D, kFwdParts<T>>::ELEMS;
}
template <int F, int D, typename T> constexpr size_t bwd_smem() {
  constexpr int P = kBwdParts<T>;
  return sizeof(bf16) * (4 * Rows<D, P>::ELEMS + Rows<kKeys<F>, P>::ELEMS +
                         Rows<kKeys<F>, kDvParts>::ELEMS + Rows<D, kDvParts>::ELEMS);
}

template <int F, int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* cosv,
                       const void* sinv, void* o, int64_t items, int heads, bt::Dropout drop,
                       cudaStream_t stream) {
  const int64_t rows = items * F;
  constexpr size_t smem = fwd_smem<F, D, T>();
  auto kern = small_fwd_kernel<F, D, T>;
  cudaError_t err = bt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((rows + kTM - 1) / kTM), kNT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)cosv, (const float*)sinv, (T*)o, rows,
      heads, drop);
  return cudaGetLastError();
}

template <int F, int D, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* cosv,
                       const void* sinv, const void* dout, void* dq, void* dk, void* dv,
                       int64_t items, int heads, bt::Dropout drop, cudaStream_t stream) {
  const int64_t rows = items * F;
  constexpr size_t smem = bwd_smem<F, D, T>();
  auto kern = small_bwd_kernel<F, D, T>;
  cudaError_t err = bt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((rows + kTM - 1) / kTM), kNT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)cosv, (const float*)sinv,
      (const T*)dout, (T*)dq, (T*)dk, (T*)dv, rows, heads, drop);
  return cudaGetLastError();
}

// CALL(F, D, T) for the runtime sequence length, head width and dtype code.
#define BT_SMALL_F(CALL, DD, TT)              \
  switch (F) {                                \
    case 1: return (int)CALL(1, DD, TT);      \
    case 2: return (int)CALL(2, DD, TT);      \
    case 4: return (int)CALL(4, DD, TT);      \
    case 8: return (int)CALL(8, DD, TT);      \
    case 16: return (int)CALL(16, DD, TT);    \
    case 32: return (int)CALL(32, DD, TT);    \
    default: return (int)cudaErrorInvalidValue; \
  }
#define BT_SMALL_DISPATCH(CALL)                                      \
  if (dtype == 0 && D == 16) BT_SMALL_F(CALL, 16, float)             \
  if (dtype == 0 && D == 32) BT_SMALL_F(CALL, 32, float)             \
  if (dtype == 1 && D == 16) BT_SMALL_F(CALL, 16, __nv_bfloat16)     \
  if (dtype == 1 && D == 32) BT_SMALL_F(CALL, 32, __nv_bfloat16)     \
  return (int)cudaErrorInvalidValue;

}  // namespace

// dtype: 0 float32, 1 bfloat16 for q, k, v and o (items, F, D), F dividing
// 32, D 16 or 32, each 16-byte aligned; cos/sin (F, D/2) float32, or both
// null for no rotation. Dropout coordinates: item / heads, item % heads;
// keep iff the Philox bits < thr, kept values times scale; on == 0 turns it
// off.
extern "C" int bt_small_attn_fwd(int dtype, int F, int D, const void* q, const void* k,
                                 const void* v, const void* cosv, const void* sinv, void* o,
                                 long long items, int heads, unsigned seed, unsigned salt,
                                 unsigned thr, float scale, int on, void* stream) {
  if (items <= 0) return 0;
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(FF, DD, TT) launch_fwd<FF, DD, TT>(q, k, v, cosv, sinv, o, items, heads, d, s)
  BT_SMALL_DISPATCH(BT_CALL)
#undef BT_CALL
}

// The forward's inputs and dout (items, F, D) in the dtype; results dq, dk,
// dv (items, F, D) in the dtype.
extern "C" int bt_small_attn_bwd(int dtype, int F, int D, const void* q, const void* k,
                                 const void* v, const void* cosv, const void* sinv,
                                 const void* dout, void* dq, void* dk, void* dv, long long items,
                                 int heads, unsigned seed, unsigned salt, unsigned thr,
                                 float scale, int on, void* stream) {
  if (items <= 0) return 0;
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(FF, DD, TT) \
  launch_bwd<FF, DD, TT>(q, k, v, cosv, sinv, dout, dq, dk, dv, items, heads, d, s)
  BT_SMALL_DISPATCH(BT_CALL)
#undef BT_CALL
}
