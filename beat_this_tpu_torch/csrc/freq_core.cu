// The attention core of the frequency block's training backward (B7,
// fused_freq_train.cu: steps 4 and 9), per (item, head) over the item's F
// rows (F dividing 32), on the tensor cores:
//   forward   s = q k^T 32^-0.5 (log2 units: times log2(e)), p = exp2(s -
//             m) with m the row maximum, l the sum of the undropped p, o =
//             round_T(round_T(p f) v / l) (f the keep factors), go =
//             round_T(o round_T(gate));
//   backward  from d_o: A = round_T(p f), Y = A v (P V unrounded), dY =
//             round_T(d_o / l), dA = dY v^T, delta = (d_o . Y) / l^2 (the
//             cotangent of l negated), ds = round_T(p (f dA - delta)) (the
//             gradient of the natural-log scores, p unnormalized); dq = ds
//             k, dk = ds^T q, each pulled back through the rotation times
//             32^-0.5, and dv = A^T dY, each rounded to T.
// Those are the rounding points of the plain version,
// ops/fused_freq.py:freq_attention_branch under autograd (round_grad on the
// scores, on P V and on q | k | v), not B12's, whose plain version rounds
// the base-2 scores' gradient.
//
// Part of the port of beat_this_tpu/ops/fused_freq.py:_fused_freq_bwd_kernel
// (fused_freq_train.cu). The design is B12's (small_attention.cu) on the
// packed block-diagonal tile of small_tile.cuh: 16 / F items (F <= 16) or
// one (F = 32) share a 16 x 16 or 32 x 32 score tile, the size of one or
// two m16n8k16 fragments across, and every product runs on mma.sync (bf16
// operands, float32 accumulators). A block of 4 warps takes 64 rows of one
// head (blockIdx.y): its threads read the head's 32 columns of q, k, v (and
// d_o) with coalesced 16-byte loads, all issued before any is used, and
// store them to shared memory as P bf16 parts (float32 three: the products
// feed sums over rows that cancel, as the gate bias's gradient; bfloat16
// one); each warp owns 16 rows as queries (S, p, P V; Y, dA, ds, dq), then as
// keys (dk, dv over the group's queries, from ds, A and dY in shared
// memory: no atomics, two runs give the same bits). The backward recomputes
// S and p from the tile: the forward saves nothing but o and go. Results
// leave through shared memory as 16-byte stores of each warp's own rows.
//
// Bound on the H100: bytes. Per (row, head) 4 F 32 FLOPs forward and 10 F
// 32 backward (14 F 32 with S and P V recomputed) against q, k, v, the gate
// and o, go read or written once (and d_o, d_qkv's parts): at most 32
// FLOPs a byte (bfloat16 backward at F 32), where the tensor cores' rate
// would allow 295 (bfloat16) or ~98 (float32's split products). Shared
// memory: float32 backward 78-90 KB (two blocks an SM), forward 45 KB;
// bfloat16 32-36 / 18 KB.
#include "freq_core.cuh"
#include "small_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using st::kNT;
using st::kTM;

constexpr int kHD = bt::kHeadDim;                        // 32
constexpr float kScale = 0.17677669529663688f;           // 32^-0.5
constexpr float kQScale = kScale * 1.4426950408889634f;  // 32^-0.5 * log2(e)

// Parts of an operand: float32's own precision (mm::full_parts;
// tests/test_torch_freq_core_tc_design.py).
template <typename T> constexpr int kParts = mm::full_parts<T>();

// x (the warp's C fragments) as P bf16 parts, part p to rows row0 .. row0 +
// nrows - 1 of dst + p lo (row stride ld), through `stage`.
template <int P>
__device__ __forceinline__ void write_parts(bf16* __restrict__ dst, int64_t ld, int64_t lo,
                                            bf16* stage, int64_t row0, int nrows,
                                            float (&x)[kHD / 8][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float part[kHD / 8][4];
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[j][e] = bt::round_to<bf16>(x[j][e]);
        x[j][e] -= part[j][e];
      }
    st::write_rows<kHD, bf16>(dst + p * lo, ld, stage, kHD + 8, row0, nrows, part);
  }
}

// The chunks of q, k, v as P parts into the three tiles from qs on.
template <typename T, int P, int N>
__device__ __forceinline__ void put_qkv(const st::Chunks<kHD, T> (&ch)[N], bf16* qs) {
  using R = st::Rows<kHD, P>;
  using CH = st::Chunks<kHD, T>;
#pragma unroll
  for (int i = 0; i < CH::N; ++i) {
    const int r = CH::row(i), c = CH::col(i);
    float x[CH::PER];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      ch[m].values(i, x);
      st::put<T, P>(qs + m * R::ELEMS + r * R::LD + c, R::LO, x);
    }
  }
}

template <int F, typename T>
__global__ void __launch_bounds__(kNT)
    freq_core_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ sig,
                         T* __restrict__ o, bf16* __restrict__ go, int64_t lo, int64_t rows,
                         int C, bt::Dropout drop) {
  constexpr int P = kParts<T>, NK = st::kKeys<F>;
  using R = st::Rows<kHD, P>;
  using CH = st::Chunks<kHD, T>;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* qs = reinterpret_cast<bf16*>(smem_b);  // then the warp's results, staged
  bf16* ks = qs + R::ELEMS;
  bf16* vs = ks + R::ELEMS;
  const int h = blockIdx.y, g = (threadIdx.x & 31) >> 2;
  const int64_t row0 = (int64_t)blockIdx.x * kTM;
  const int nrows = (int)min((int64_t)kTM, rows - row0);
  const int rw = 16 * (threadIdx.x >> 5), grp = NK == 16 ? rw : rw & ~31;
  uint32_t bits[2];
  {
    CH ch[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) ch[m].load(qkv + m * C + h * kHD, 3 * C, row0, nrows);
    // while the loads are in flight
    st::keep_bits<F>(drop, row0 + grp, rw - grp, 1, h, bits);
    put_qkv<T, P>(ch, qs);
  }
  __syncthreads();

  float s[NK / 8][4], l[2];
  st::probabilities<F, kHD, P, true>(s, l, qs, ks, rw, grp, kQScale);
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[j][2 * hh + e] *= st::keep_factor(drop, bits[hh], 2 * j + e);
  // o = round_T(round_T(p f) V / l)
  float acc[kHD / 8][4];
  tc::zero_frags(acc);
  {
    uint32_t pa[P][NK / 16][4];
    st::frags_to_a<P, NK / 16>(pa, s);
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t ak[P][4];
      st::kstep(ak, pa, kk);
#pragma unroll
      for (int c = 0; c < kHD / 16; ++c)
        st::mma_nn<P>(acc[2 * c], acc[2 * c + 1], ak, vs + grp * R::LD, R::LO, R::LD, 16 * kk,
                      16 * c);
    }
  }
  float gate[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rw + g + 8 * hh;
    gate[hh] = r < nrows ? bt::round_to<T>(__ldg(sig + (row0 + r) * (C / kHD) + h)) : 0.f;
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[j][2 * hh + e] = bt::round_to<T>(acc[j][2 * hh + e] / l[hh]);
  }
  // o, then go, leave through the warp's own rows of q's tile, which no
  // other warp reads
  constexpr int SD = kHD + CH::PER;
  static_assert(sizeof(T) * SD <= sizeof(bf16) * R::LD, "a result row fits in a tile's row");
  bf16* stage = qs + rw * R::LD;
  st::write_rows<kHD, T>(o + h * kHD, C, reinterpret_cast<T*>(stage), SD, row0 + rw, nrows - rw,
                         acc);
#pragma unroll
  for (int j = 0; j < kHD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= gate[e >> 1];
  write_parts<P>(go + h * kHD, C, lo, stage, row0 + rw, nrows - rw, acc);
}

template <int F, typename T>
__global__ void __launch_bounds__(kNT)
    freq_core_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dO,
                         const float* __restrict__ cosv, const float* __restrict__ sinv,
                         bf16* __restrict__ dqkv, int64_t dlo, int64_t rows, int C,
                         bt::Dropout drop) {
  constexpr int P = kParts<T>, NK = st::kKeys<F>;
  using R = st::Rows<kHD, P>;
  using RK = st::Rows<NK, P>;
  using CH = st::Chunks<kHD, T>;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* qs = reinterpret_cast<bf16*>(smem_b);  // q as rotated and rounded
  bf16* ks = qs + R::ELEMS;                    // then the warp's results, staged
  bf16* vs = ks + R::ELEMS;
  bf16* dys = vs + R::ELEMS;     // d_o as given; then dY = round_T(d_o / l) as P parts
  bf16* dss = dys + R::ELEMS;    // ds, (query, key of the group)
  bf16* pfs = dss + RK::ELEMS;   // A = round_T(p f), p unnormalized
  const int h = blockIdx.y, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t row0 = (int64_t)blockIdx.x * kTM;
  const int nrows = (int)min((int64_t)kTM, rows - row0);
  const int rw = 16 * (threadIdx.x >> 5), grp = NK == 16 ? rw : rw & ~31, qb = rw - grp;
  uint32_t bits[2];
  {
    CH ch[3], cd;
#pragma unroll
    for (int m = 0; m < 3; ++m) ch[m].load(qkv + m * C + h * kHD, 3 * C, row0, nrows);
    cd.load(dO + h * kHD, C, row0, nrows);
    // while the loads are in flight
    st::keep_bits<F>(drop, row0 + grp, qb, 1, h, bits);
    put_qkv<T, P>(ch, qs);
#pragma unroll
    for (int i = 0; i < CH::N; ++i)
      *reinterpret_cast<uint4*>(reinterpret_cast<T*>(dys + CH::row(i) * R::LD) + CH::col(i)) =
          cd.c[i];
  }
  __syncthreads();

  float dq[kHD / 8][4];
  {
    float s[NK / 8][4], l[2];
    st::probabilities<F, kHD, P, true>(s, l, qs, ks, rw, grp, kQScale);
    // A = round_T(p f) (p unnormalized) to shared memory for dv, and Y = A V,
    // the forward's product before it is rounded
    float y[kHD / 8][4];
    tc::zero_frags(y);
    {
      float af[NK / 8][4];
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            af[j][2 * hh + e] = bt::round_to<T>(s[j][2 * hh + e] *
                                                st::keep_factor(drop, bits[hh], 2 * j + e));
          mm::store2<P>(pfs + (rw + g + 8 * hh) * RK::LD + 8 * j + 2 * t, RK::LO, af[j][2 * hh],
                        af[j][2 * hh + 1]);
        }
      uint32_t pa[P][NK / 16][4];
      st::frags_to_a<P, NK / 16>(pa, af);
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        uint32_t ak[P][4];
        st::kstep(ak, pa, kk);
#pragma unroll
        for (int c = 0; c < kHD / 16; ++c)
          st::mma_nn<P>(y[2 * c], y[2 * c + 1], ak, vs + grp * R::LD, R::LO, R::LD, 16 * kk,
                        16 * c);
      }
    }
    // dY = round_T(d_o / l) in place of the warp's own rows of d_o, and
    // delta = (d_o . Y) / l^2, the cotangent of l negated
    float dy[kHD / 8][4], delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const T* src = reinterpret_cast<const T*>(dys + (rw + g + 8 * hh) * R::LD) + 8 * j + 2 * t;
        const float d0 = bt::to_f(src[0]), d1 = bt::to_f(src[1]);
        delta[hh] += d0 * y[j][2 * hh] + d1 * y[j][2 * hh + 1];
        dy[j][2 * hh] = bt::round_to<T>(d0 / l[hh]);
        dy[j][2 * hh + 1] = bt::round_to<T>(d1 / l[hh]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) delta[hh] = tc::quad_sum(delta[hh]) / (l[hh] * l[hh]);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        mm::store2<P>(dys + (rw + g + 8 * hh) * R::LD + 8 * j + 2 * t, R::LO, dy[j][2 * hh],
                      dy[j][2 * hh + 1]);
    __syncwarp();
    // dA = dY V^T over the group's keys
    float da[NK / 8][4];
    tc::zero_frags(da);
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      uint32_t a[P][4];
      st::load_a<P>(a, dys, R::LO, R::LD, rw, 16 * kk);
#pragma unroll
      for (int np = 0; np < NK / 16; ++np)
        st::mma_nt<P>(da[2 * np], da[2 * np + 1], a, vs + grp * R::LD, R::LO, R::LD, np,
                      16 * kk);
    }
    // ds = round_T(p (f dA - delta)), into s and to shared memory
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float f = st::keep_factor(drop, bits[hh], 2 * j + e);
          s[j][2 * hh + e] =
              bt::round_to<T>(s[j][2 * hh + e] * (f * da[j][2 * hh + e] - delta[hh]));
        }
        mm::store2<P>(dss + (rw + g + 8 * hh) * RK::LD + 8 * j + 2 * t, RK::LO, s[j][2 * hh],
                      s[j][2 * hh + 1]);
      }
    // dq = ds K
    tc::zero_frags(dq);
    uint32_t dsa[P][NK / 16][4];
    st::frags_to_a<P, NK / 16>(dsa, s);
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t ak[P][4];
      st::kstep(ak, dsa, kk);
#pragma unroll
      for (int c = 0; c < kHD / 16; ++c)
        st::mma_nn<P>(dq[2 * c], dq[2 * c + 1], ak, ks + grp * R::LD, R::LO, R::LD, 16 * kk,
                      16 * c);
    }
  }
  __syncthreads();  // ds, A and dY of both warps of a group; k and v are read no more

  // the warp's rows as keys, sums over the group's queries: dk = ds^T Q, dv
  // = A^T dY
  float dk[kHD / 8][4], dv[kHD / 8][4];
  tc::zero_frags(dk);
  tc::zero_frags(dv);
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[P][4];
    st::load_at<P>(a, dss + grp * RK::LD, RK::LO, RK::LD, qb, 16 * kk);
#pragma unroll
    for (int c = 0; c < kHD / 16; ++c)
      st::mma_nn<P>(dk[2 * c], dk[2 * c + 1], a, qs + grp * R::LD, R::LO, R::LD, 16 * kk, 16 * c);
    st::load_at<P>(a, pfs + grp * RK::LD, RK::LO, RK::LD, qb, 16 * kk);
#pragma unroll
    for (int c = 0; c < kHD / 16; ++c)
      st::mma_nn<P>(dv[2 * c], dv[2 * c + 1], a, dys + grp * R::LD, R::LO, R::LD, 16 * kk,
                    16 * c);
  }
  st::pull_back<F, kHD, T>(dq, rw, cosv, sinv, kScale);
  st::pull_back<F, kHD, T>(dk, rw, cosv, sinv, kScale);
#pragma unroll
  for (int j = 0; j < kHD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[j][e] = bt::round_to<T>(dv[j][e]);
  // [d_q | d_k | d_v] leave through the warp's own rows of k's tile
  bf16* stage = ks + rw * R::LD;
  bf16* dst = dqkv + h * kHD;
  write_parts<P>(dst, 3 * C, dlo, stage, row0 + rw, nrows - rw, dq);
  write_parts<P>(dst + C, 3 * C, dlo, stage, row0 + rw, nrows - rw, dk);
  write_parts<P>(dst + 2 * C, 3 * C, dlo, stage, row0 + rw, nrows - rw, dv);
}

// Shared-memory bytes of the forward (q, k, v tiles) and the backward (q, k,
// v, dY; ds and A).
template <typename T> constexpr size_t fwd_smem() {
  return sizeof(bf16) * 3 * st::Rows<kHD, kParts<T>>::ELEMS;
}
template <int F, typename T> constexpr size_t bwd_smem() {
  return sizeof(bf16) *
         (4 * st::Rows<kHD, kParts<T>>::ELEMS + 2 * st::Rows<st::kKeys<F>, kParts<T>>::ELEMS);
}

inline dim3 core_grid(int64_t rows, int C) {
  return dim3((unsigned)((rows + kTM - 1) / kTM), (unsigned)(C / kHD));
}

template <int F, typename T>
cudaError_t launch_fwd(const T* qkv, const float* sig, T* o, bf16* go, int64_t lo, int64_t rows,
                       int C, bt::Dropout drop, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<T>();
  auto kern = freq_core_fwd_kernel<F, T>;
  cudaError_t err = bt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<core_grid(rows, C), kNT, smem, stream>>>(qkv, sig, o, go, lo, rows, C, drop);
  return cudaGetLastError();
}

template <int F, typename T>
cudaError_t launch_bwd(const T* qkv, const T* dO, const float* cosv, const float* sinv,
                       bf16* dqkv, int64_t dlo, int64_t rows, int C, bt::Dropout drop,
                       cudaStream_t stream) {
  constexpr size_t smem = bwd_smem<F, T>();
  auto kern = freq_core_bwd_kernel<F, T>;
  cudaError_t err = bt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<core_grid(rows, C), kNT, smem, stream>>>(qkv, dO, cosv, sinv, dqkv, dlo, rows, C, drop);
  return cudaGetLastError();
}

}  // namespace

// CALL(F) for the runtime F.
#define BT_CORE_F(CALL)                  \
  switch (F) {                           \
    case 1: return CALL(1);              \
    case 2: return CALL(2);              \
    case 4: return CALL(4);              \
    case 8: return CALL(8);              \
    case 16: return CALL(16);            \
    case 32: return CALL(32);            \
    default: return cudaErrorInvalidValue; \
  }

namespace fc {

template <typename T>
cudaError_t core_fwd(const T* qkv, const float* sig, T* o, __nv_bfloat16* go, int64_t lo,
                     int64_t rows, int C, int F, bt::Dropout drop, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
#define BT_CALL(FF) launch_fwd<FF, T>(qkv, sig, o, go, lo, rows, C, drop, stream)
  BT_CORE_F(BT_CALL)
#undef BT_CALL
}

template <typename T>
cudaError_t core_bwd(const T* qkv, const T* dO, const float* cosv, const float* sinv,
                     __nv_bfloat16* dqkv, int64_t dlo, int64_t rows, int C, int F,
                     bt::Dropout drop, cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
#define BT_CALL(FF) launch_bwd<FF, T>(qkv, dO, cosv, sinv, dqkv, dlo, rows, C, drop, stream)
  BT_CORE_F(BT_CALL)
#undef BT_CALL
}

template cudaError_t core_fwd<float>(const float*, const float*, float*, __nv_bfloat16*, int64_t,
                                     int64_t, int, int, bt::Dropout, cudaStream_t);
template cudaError_t core_fwd<__nv_bfloat16>(const __nv_bfloat16*, const float*, __nv_bfloat16*,
                                             __nv_bfloat16*, int64_t, int64_t, int, int,
                                             bt::Dropout, cudaStream_t);
template cudaError_t core_bwd<float>(const float*, const float*, const float*, const float*,
                                     __nv_bfloat16*, int64_t, int64_t, int, int, bt::Dropout,
                                     cudaStream_t);
template cudaError_t core_bwd<__nv_bfloat16>(const __nv_bfloat16*, const __nv_bfloat16*,
                                             const float*, const float*, __nv_bfloat16*, int64_t,
                                             int64_t, int, int, bt::Dropout, cudaStream_t);

}  // namespace fc

#undef BT_CORE_F
