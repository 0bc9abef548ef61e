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

using st::kNT;
using st::kTM;
using st::kKeys;
using st::Rows;

// bf16 parts of an operand: the forward's at float32's own precision, the
// backward's about 16 bits (tests/test_torch_small_tc_design.py).
// ln 2: the gradient of exp2.
constexpr float kLn2 = 0.6931471805599453f;
// Parts of dv's operands, round_T(p f) and dout / l, in both dtypes: the
// plain version takes that product in float32.
constexpr int kDvParts = 3;
template <typename T> constexpr int kFwdParts = mm::full_parts<T>();
template <typename T> constexpr int kBwdParts = mm::split_parts<T>();

template <int F, int D, typename T>
__global__ void __launch_bounds__(kNT)
    small_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ cosv, const float* __restrict__ sinv,
                     T* __restrict__ o, int64_t rows, int heads, bt::Dropout drop) {
  constexpr int P = kFwdParts<T>, NK = kKeys<F>;
  using R = Rows<D, P>;
  using C = st::Chunks<D, T>;
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
    cq.load(q, D, row0, nrows);
    ck.load(k, D, row0, nrows);
    cv.load(v, D, row0, nrows);
    // while the loads are in flight
    st::keep_bits<F>(drop, row0 + grp, rw - grp, heads, 0, bits);
#pragma unroll
    for (int i = 0; i < C::N; ++i) {
      const int r = C::row(i), c = C::col(i);
      const st::Angles<D, C::PER / 2> rope(cosv, sinv, r % F, c);
      float x[C::PER];
      cq.values(i, x);
      rope.rotate(x);
      st::put<T, P>(qs + r * R::LD + c, R::LO, x, bt::qscale<D>());
      ck.values(i, x);
      rope.rotate(x);
      st::put<T, P>(ks + r * R::LD + c, R::LO, x);
      cv.values(i, x);
      st::put<T, P>(vs + r * R::LD + c, R::LO, x);
    }
  }
  __syncthreads();

  float s[NK / 8][4], l[2];
  st::probabilities<F, D, P>(s, l, qs, ks, rw, grp);
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[j][2 * hh + e] *= st::keep_factor(drop, bits[hh], 2 * j + e);
  // o = round_T(round_T(p f) V / l)
  float acc[D / 8][4];
  tc::zero_frags(acc);
  {
    uint32_t pa[P][NK / 16][4];
    st::frags_to_a<P, NK / 16>(pa, s);
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t ak[P][4];
      st::kstep(ak, pa, kk);
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
  st::write_rows<D, T>(o, D, reinterpret_cast<T*>(qs + rw * R::LD), SD, row0 + rw, nrows - rw,
                          acc);
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
  using C = st::Chunks<D, T>;
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
    cq.load(q, D, row0, nrows);
    ck.load(k, D, row0, nrows);
    cv.load(v, D, row0, nrows);
    cd.load(dout, D, row0, nrows);
    // while the loads are in flight
    st::keep_bits<F>(drop, row0 + grp, qb, heads, 0, bits);
#pragma unroll
    for (int i = 0; i < C::N; ++i) {
      const int r = C::row(i), c = C::col(i);
      const st::Angles<D, C::PER / 2> rope(cosv, sinv, r % F, c);
      float x[C::PER];
      cq.values(i, x);
      rope.rotate(x);
      st::put<T, P>(qs + r * R::LD + c, R::LO, x, bt::qscale<D>());
      ck.values(i, x);
      rope.rotate(x);
      st::put<T, P>(ks + r * R::LD + c, R::LO, x);
      cv.values(i, x);
      st::put<T, P>(vs + r * R::LD + c, R::LO, x);
      cd.values(i, x);
      st::put<T, P>(dos + r * R::LD + c, R::LO, x);
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
    st::probabilities<F, D, P>(s, l, qs, ks, rw, grp);
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
                                       st::keep_factor(drop, bits[hh], 2 * j + e)) *
                       dp[j][2 * hh + e];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) delta[hh] = tc::quad_sum(delta[hh]) / l[hh];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = s[j][2 * hh + e], f = st::keep_factor(drop, bits[hh], 2 * j + e);
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
      st::kstep(ak, da, kk);
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        st::mma_nn<P>(dq[2 * c], dq[2 * c + 1], ak, ks + grp * R::LD, R::LO, R::LD, 16 * kk,
                      16 * c);
    }
    st::pull_back<F, D, T>(dq, rw, cosv, sinv, bt::qscale<D>());
    st::write_rows<D, T>(dq_out, D, stage, SD, row0 + rw, nrows - rw, dq);
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
  st::pull_back<F, D, T>(dk, rw, cosv, sinv, 1.f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[j][e] = bt::round_to<T>(dv[j][e]);
  st::write_rows<D, T>(dk_out, D, stage, SD, row0 + rw, nrows - rw, dk);
  st::write_rows<D, T>(dv_out, D, stage, SD, row0 + rw, nrows - rw, dv);
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
// null for no rotation. Dropout coordinates: item0 + item / heads, item %
// heads (row0 is unused); keep iff the Philox bits < thr, kept values times
// scale; on == 0 turns it off.
extern "C" int bt_small_attn_fwd(int dtype, int F, int D, const void* q, const void* k,
                                 const void* v, const void* cosv, const void* sinv, void* o,
                                 long long items, int heads, unsigned seed, unsigned salt,
                                 unsigned thr, float scale, int on, unsigned item0, unsigned row0,
                                 void* stream) {
  if (items <= 0) return 0;
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on, item0, row0);
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
                                 float scale, int on, unsigned item0, unsigned row0, void* stream) {
  if (items <= 0) return 0;
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on, item0, row0);
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(FF, DD, TT) \
  launch_bwd<FF, DD, TT>(q, k, v, cosv, sinv, dout, dq, dk, dv, items, heads, d, s)
  BT_SMALL_DISPATCH(BT_CALL)
#undef BT_CALL
}
