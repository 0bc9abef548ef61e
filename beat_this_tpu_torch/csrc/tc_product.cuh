// The staged tensor-core product of the training kernels (B8 / B9,
// ff_train.cuh; B4 / B5, fused_time_train.cu; B7, fused_freq_train.cu): a
// block of 8 warps takes a 128-row tile of A times a BN-column tile of B over
// a depth range, on mma.sync m16n8k16 (bf16 operands, float32 accumulators,
// mma.cuh), through a 3-deep cp.async ring of 32-deep staged tiles. An
// operand has P bf16 parts `lo` elements apart: P = 1 is bf16 itself; float32
// splits a value into P = 2 parts (a = a_hi + a_lo, three bf16 products a_hi
// b_hi + a_hi b_lo + a_lo b_hi, about 16 significant bits against plain
// TF32's 11) or P = 3 (a = a_0 + a_1 + a_2, the six products of parts i, j
// with i + j <= 2, each k-step summed apart: float32's 24 bits). Also the
// bf16 operand stores and the launch that converts matrices into operands,
// the keep factors of a row-major dropout site in C fragments, products of
// up to two jobs in one launch, and the fixed-order sums of per-block
// partials in one launch.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {
namespace mm {

using bf16 = __nv_bfloat16;

constexpr int kTM = 128;    // rows of a product block (M side); rows of a row-pass block
constexpr int kTK = 32;     // depth of a staged tile
constexpr int kStages = 3;  // staged tiles in flight (cp.async ring)
constexpr int kAlign = 256; // scratch sections start on multiples of this many bytes
constexpr int kCardSMs = 132;  // streaming multiprocessors of the H100 SXM

// A bf16 matrix operand with row stride `ld`; part p (p > 0: what the parts
// before it leave of the value, rounded to bf16) lies p `lo` elements after
// the first.
struct Operand {
  const bf16* p;
  int64_t ld, lo;
};

// The parts of an operand at float32's own precision: three in float32,
// one in bf16 (its own operand).
template <typename T> constexpr int full_parts() {
  return std::is_same<T, float>::value ? 3 : 1;
}

// The parts of an operand where about 16 bits do (B4 / B5 / B9 and the
// eval kernels K1 / K2): two in float32 (three bf16 products), one in bf16.
template <typename T> constexpr int split_parts() {
  return std::is_same<T, float>::value ? 2 : 1;
}

// bf16 elements of one staged tile. A is staged [m][k] (k contiguous) or,
// with AM, [k][m]; B always [k][n]. The 8-element pad puts the 8 rows an
// ldmatrix reads in 8 different bank groups.
template <bool AM> __host__ __device__ constexpr int a_tile() {
  return AM ? kTK * (kTM + 8) : kTM * (kTK + 8);
}
template <int BN> __host__ __device__ constexpr int b_tile() { return kTK * (BN + 8); }
template <bool AM, int BN, int P> __host__ __device__ constexpr int stage_elems() {
  return P * (a_tile<AM>() + b_tile<BN>());
}
template <bool AM, int BN, int P> constexpr size_t product_smem() {
  return sizeof(bf16) * kStages * stage_elems<AM, BN, P>();
}

// Stage depth [k0, k0 + kTK) of A's rows [m0, m0 + kTM) and of B's columns
// [n0, n0 + BN) into `st` by cp.async, zeros at m >= m_end, n >= n_end or
// k >= k_end. Bounds along a contiguous axis are multiples of 8.
template <bool AM, int BN, int P>
__device__ __forceinline__ void stage(bf16* st, const Operand& A, const Operand& B, int64_t m0,
                                      int n0, int64_t k0, int64_t m_end, int n_end,
                                      int64_t k_end) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    bf16* as = st + p * a_tile<AM>();
    const bf16* ap = A.p + p * A.lo;
    if constexpr (AM) {
      constexpr int CH = kTM / 8;
      for (int e = threadIdx.x; e < kTK * CH; e += bt::kThreads) {
        const int r = e / CH, c = e % CH;
        const int64_t k = k0 + r, m = m0 + 8 * c;
        const bool ok = k < k_end && m < m_end;
        bt::cp_async16(as + r * (kTM + 8) + 8 * c, ap + (ok ? k * A.ld + m : 0), ok);
      }
    } else {
      constexpr int CH = kTK / 8;
      for (int e = threadIdx.x; e < kTM * CH; e += bt::kThreads) {
        const int r = e / CH, c = e % CH;
        const int64_t m = m0 + r, k = k0 + 8 * c;
        const bool ok = m < m_end && k < k_end;
        bt::cp_async16(as + r * (kTK + 8) + 8 * c, ap + (ok ? m * A.ld + k : 0), ok);
      }
    }
  }
  bf16* bs = st + P * a_tile<AM>();
#pragma unroll
  for (int p = 0; p < P; ++p) {
    constexpr int CH = BN / 8;
    const bf16* bp = B.p + p * B.lo;
    for (int e = threadIdx.x; e < kTK * CH; e += bt::kThreads) {
      const int r = e / CH, c = e % CH;
      const int64_t k = k0 + r;
      const int n = n0 + 8 * c;
      const bool ok = k < k_end && n < n_end;
      bt::cp_async16(bs + p * b_tile<BN>() + r * (BN + 8) + 8 * c, bp + (ok ? k * B.ld + n : 0),
                     ok);
    }
  }
}

// c += a b for one m16n8k16 fragment over operands of P parts (a: the
// parts' A fragments; b0, b1: their two B registers), the products of parts
// i, j with i + j < P, the small terms first (P = 2: a_lo b_hi, a_hi b_lo,
// a_hi b_hi). With three parts this step's small terms and its product of
// the first parts each go into fresh accumulators and reach c by float32
// adds, so the tensor cores round no sum longer than one k-step
// (accumulating in c, they drifted by ~2e-5 over thousands of rows:
// PERF.md, Findings).
template <int P>
__device__ __forceinline__ void mma_parts(float (&c)[4], const uint32_t (&a)[P][4],
                                          const uint32_t (&b0)[P], const uint32_t (&b1)[P]) {
  if constexpr (P == 3) {
    float sm[4] = {0.f, 0.f, 0.f, 0.f}, big[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 2; t >= 1; --t)
#pragma unroll
      for (int i = t; i >= 0; --i) bt::mma_bf16(sm, a[i], b0[t - i], b1[t - i]);
    bt::mma_bf16(big, a[0], b0[0], b1[0]);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += big[e] + sm[e];
  } else {
#pragma unroll
    for (int t = P - 1; t >= 0; --t)
#pragma unroll
      for (int i = t; i >= 0; --i) bt::mma_bf16(c, a[i], b0[t - i], b1[t - i]);
  }
}

// acc += the block's staged A tile times its B tile. The 8 warps are 4 (m)
// x 2 (n): warp w owns rows 32 (w % 4) .. + 31 and columns BN / 2 (w / 4)
// .. + BN / 2 - 1; acc[mi][j] is the C fragment of rows 16 mi .. + 15 and
// columns 8 j .. + 7 of that.
template <bool AM, int BN, int P>
__device__ __forceinline__ void mma_stage(float (&acc)[2][BN / 16][4], const bf16* st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp & 3), wn = (BN / 2) * (warp >> 2);
  const bf16* bs = st + P * a_tile<AM>();
#pragma unroll
  for (int kk = 0; kk < kTK / 16; ++kk) {
    uint32_t a[P][2][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* as = st + p * a_tile<AM>();
        if constexpr (AM)
          bt::ldsm_x4_t(a[p][mi], as + (16 * kk + (lane & 7) + 8 * (lane >> 4)) * (kTM + 8) +
                                      wm + 16 * mi + 8 * ((lane >> 3) & 1));
        else
          bt::ldsm_x4(a[p][mi],
                      as + (wm + 16 * mi + (lane & 15)) * (kTK + 8) + 16 * kk + 8 * (lane >> 4));
      }
#pragma unroll
    for (int nb = 0; nb < BN / 32; ++nb) {
      uint32_t b[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
        bt::ldsm_x4_t(b[p], bs + p * b_tile<BN>() +
                                (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * (BN + 8) + wn +
                                16 * nb + 8 * (lane >> 4));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t am[P][4], b0[P], b1[P];
#pragma unroll
          for (int p = 0; p < P; ++p) {
#pragma unroll
            for (int r = 0; r < 4; ++r) am[p][r] = a[p][mi][r];
            b0[p] = b[p][2 * h];
            b1[p] = b[p][2 * h + 1];
          }
          mma_parts<P>(acc[mi][2 * nb + h], am, b0, b1);
        }
    }
  }
}

// acc = A[m0 .. m0 + kTM) B[:, n0 .. n0 + BN) over depth [k_begin, k_end),
// through a kStages-deep cp.async ring in `smem`. Ends with a barrier, so
// `smem` is free again.
template <bool AM, int BN, int P>
__device__ __forceinline__ void product(float (&acc)[2][BN / 16][4], const Operand& A,
                                        const Operand& B, int64_t m0, int n0, int64_t k_begin,
                                        int64_t k_end, int64_t m_end, int n_end, bf16* smem) {
  static_assert(P >= 1 && P <= 3, "operands have 1, 2 or 3 parts");
  constexpr int S = stage_elems<AM, BN, P>();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
  const int nk = k_end > k_begin ? (int)((k_end - k_begin + kTK - 1) / kTK) : 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      stage<AM, BN, P>(smem + s * S, A, B, m0, n0, k_begin + (int64_t)s * kTK, m_end, n_end,
                           k_end);
    bt::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    bt::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = kt + kStages - 1;
    if (nx < nk)
      stage<AM, BN, P>(smem + (nx % kStages) * S, A, B, m0, n0, k_begin + (int64_t)nx * kTK,
                           m_end, n_end, k_end);
    bt::cp_async_commit();
    mma_stage<AM, BN, P>(acc, smem + (kt % kStages) * S);
  }
  bt::cp_async_wait<0>();
  __syncthreads();
}

// The block's product tile stored as float32: element (m, n) of A B over
// the block's depth slice at out[m * ldo + n], or with trans_out at
// out[n * ldo + m]; rows m >= m_end and columns n >= n_end are not stored.
template <int BN>
__device__ __forceinline__ void store_product(const float (&acc)[2][BN / 16][4],
                                              float* __restrict__ out, int64_t ldo, int trans_out,
                                              int64_t m0, int n0, int64_t m_end, int n_end) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp & 3), wn = (BN / 2) * (warp >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t m = m0 + wm + 16 * mi + (lane >> 2) + 8 * h;
        const int n = n0 + wn + 8 * j + 2 * (lane & 3);
        if (m >= m_end || n >= n_end) continue;
        const float v0 = acc[mi][j][2 * h], v1 = acc[mi][j][2 * h + 1];
        if (trans_out) {
          out[n * ldo + m] = v0;
          out[(n + 1) * ldo + m] = v1;
        } else {
          *reinterpret_cast<float2*>(out + m * ldo + n) = make_float2(v0, v1);
        }
      }
}

// v0, v1 as P bf16 parts at p[0], p[1] (part 0 rounded to nearest even,
// which is round_T for bf16), p[lo], p[lo + 1] (what part 0 leaves) and
// p[2 lo], p[2 lo + 1] (what parts 0 and 1 leave).
template <int P>
__device__ __forceinline__ void store2(bf16* p, int64_t lo, float v0, float v1) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const uint32_t part = bt::pack_bf16(v0, v1);
    *reinterpret_cast<uint32_t*>(p + k * lo) = part;
    if (k + 1 < P) {
      const float2 h = bt::unpack_bf16(part);
      v0 -= h.x;
      v1 -= h.y;
    }
  }
}

template <int P>
__device__ __forceinline__ void store4(bf16* p, int64_t lo, const float (&v)[4]) {
  store2<P>(p, lo, v[0], v[1]);
  store2<P>(p + 2, lo, v[2], v[3]);
}

// Keep factors of a row-major dropout site (item 0, head 0: the FF hidden
// and output sites, the attention output site) for this lane's columns
// col8 + 2t, col8 + 2t + 1 (t = lane % 4) in rows `row` (f[0]) and row + 8
// (f[1]). A 4-column Philox group spans lanes t = 2u and 2u + 1: the even
// lane draws row `row`'s group, the odd lane row + 8's, and they trade by
// one shuffle, so every group is drawn once. Every lane of the warp must
// call it.
__device__ __forceinline__ void row_keep(const bt::Dropout& d, uint32_t site, int64_t row,
                                         int col8, float (&f)[2][2]) {
  if (!d.on) {
    f[0][0] = f[0][1] = f[1][0] = f[1][1] = 1.f;
    return;
  }
  const int t = threadIdx.x & 3, odd = t & 1;
  const uint4 b = bt::philox4x32_10(
      make_uint4((uint32_t)(col8 >> 2) + (t >> 1), (uint32_t)(row + 8 * odd) + d.row0, 0u,
                 site << 16),
      d.seed, d.salt);
  const uint32_t mine = (uint32_t)(b.x < d.thr) | ((uint32_t)(b.y < d.thr) << 1) |
                        ((uint32_t)(b.z < d.thr) << 2) | ((uint32_t)(b.w < d.thr) << 3);
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
  const uint32_t r0 = odd ? other : mine, r1 = odd ? mine : other;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    f[0][e] = (r0 >> (2 * odd + e)) & 1u ? d.scale : 0.f;
    f[1][e] = (r1 >> (2 * odd + e)) & 1u ? d.scale : 0.f;
  }
}

// A backward's fixed-order sums of its partials, in one launch: job j sums
// parts[j] float32 partials of n[j] values (part[j][p n[j] + i]) into
// out[j]; blocks first[j] .. first[j + 1] - 1 take its 128-value slices
// (finish() sets first and returns the block count).
template <int J> struct SumJobs {
  static constexpr int kJobs = J;
  const float* part[J];
  float* out[J];
  int parts[J];
  int64_t n[J];
  unsigned first[J + 1];

  void set(int j, const float* p, float* o, int64_t np, int64_t nv) {
    part[j] = p;
    out[j] = o;
    parts[j] = (int)np;
    n[j] = nv;
  }
  unsigned finish() {
    first[0] = 0;
    for (int j = 0; j < J; ++j) first[j + 1] = first[j] + (unsigned)((n[j] + 127) / 128);
    return first[J];
  }
};

// The body of a sums launch of 256 threads: lane l of warp w sums values
// 4 l .. 4 l + 3 of the block's slice over parts w, w + 8, ..., then warp 0
// adds the 8 warps' sums in order (float4 loads where n[j] is a multiple of
// 4, single floats otherwise).
template <int J> __device__ __forceinline__ void column_sums(const SumJobs<J>& s) {
  __shared__ float4 red[8][32];
  int j = 0;
  while (blockIdx.x >= s.first[j + 1]) ++j;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = s.n[j], i = ((int64_t)(blockIdx.x - s.first[j]) * 32 + lane) * 4;
  const float* part = s.part[j];
  const bool vec = n % 4 == 0;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n)
    for (int p = warp; p < s.parts[j]; p += 8) {
      float4 v;
      if (vec) {
        v = *reinterpret_cast<const float4*>(part + p * n + i);
      } else {
        const float* q = part + p * n + i;
        v = make_float4(q[0], i + 1 < n ? q[1] : 0.f, i + 2 < n ? q[2] : 0.f,
                        i + 3 < n ? q[3] : 0.f);
      }
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && i < n) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < 8; ++w) {
      const float4 v = red[w][lane];
      t.x += v.x, t.y += v.y, t.z += v.z, t.w += v.w;
    }
    if (vec) {
      *reinterpret_cast<float4*>(s.out[j] + i) = t;
    } else {
      float* o = s.out[j] + i;
      o[0] = t.x;
      if (i + 1 < n) o[1] = t.y;
      if (i + 2 < n) o[2] = t.z;
      if (i + 3 < n) o[3] = t.w;
    }
  }
}

// Row passes (ff_train.cuh, time_qkv.cuh, fused_freq_train.cu): 8 warps a
// block; a row takes L = min(32, C / 4) lanes, each over NG = C / (4 L)
// groups of 4 columns (q + L i for lane q of the row); a warp covers 32 / L
// rows at once.
template <int C> struct RowMap {
  static constexpr int L = C / 4 < 32 ? C / 4 : 32, NG = C / (4 * L), RPW = 32 / L;
};

template <typename T> __device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = bt::to_f(p[e]);
}

// Columns (of C) per block of a product whose output has C columns.
__host__ __device__ constexpr int product_n(int C) { return C <= 64 ? 64 : 128; }

// Row groups of a weight-gradient product: ceil(rows / group_rows).
inline int64_t row_groups(int64_t rows, int64_t group_rows) {
  return (rows + group_rows - 1) / group_rows;
}

// Carves a scratch buffer into sections, each starting on a multiple of
// kAlign bytes; on a null base it gives the size alone.
struct Carver {
  uintptr_t at;
  size_t bytes = 0;
  explicit Carver(void* base) : at(reinterpret_cast<uintptr_t>(base)) {}
  template <typename P> P* take(int64_t n) {
    void* p = reinterpret_cast<void*>(at + bytes);
    bytes += (n * sizeof(P) + kAlign - 1) / kAlign * kAlign;
    return static_cast<P*>(p);
  }
};

// One conversion of a (rows, cols) matrix into a bf16 operand (parts `lo`
// elements apart), as it is or transposed to (cols, rows).
struct ConvJob {
  const void* src;
  bf16* dst;
  int64_t rows, cols, lo;
  int trans;
};

constexpr int kConvTile = 32;  // a transposed conversion's square tile per block

// Up to five conversions in one launch of operands_kernel: blocks first[j]
// .. first[j + 1] - 1 take job j, two elements a thread as it is, a 32 x 32
// tile a block transposed.
struct ConvJobs {
  static constexpr int kMax = 5;
  ConvJob job[kMax];
  int count = 0;
  unsigned first[kMax + 1] = {0};

  void add(const void* src, bf16* dst, int64_t rows, int64_t cols, int trans) {
    job[count] = ConvJob{src, dst, rows, cols, rows * cols, trans};
    const int64_t blocks =
        trans ? ((rows + kConvTile - 1) / kConvTile) * ((cols + kConvTile - 1) / kConvTile)
              : (rows * cols / 2 + bt::kThreads - 1) / bt::kThreads;
    first[count + 1] = first[count] + (unsigned)blocks;
    ++count;
  }
  unsigned blocks() const { return first[count]; }
};

template <int P>
__device__ __forceinline__ void store1(bf16* p, int64_t lo, float v) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const bf16 part = __float2bfloat16(v);
    p[k * lo] = part;
    v -= __bfloat162float(part);
  }
}

// The conversions of a launch of convert<T, P>: matrices of T into P parts.
// A transposed job goes through a 32 x 32 tile in shared memory, so that
// both its reads and its writes are coalesced.
template <typename T, int P>
__global__ void __launch_bounds__(bt::kThreads) operands_kernel(ConvJobs s) {
  __shared__ float tile[kConvTile][kConvTile + 1];
  int j = 0;
  while (blockIdx.x >= s.first[j + 1]) ++j;
  const ConvJob& jb = s.job[j];
  const T* src = static_cast<const T*>(jb.src);
  const int64_t b = blockIdx.x - s.first[j];
  if (jb.trans) {
    const int64_t tcols = (jb.cols + kConvTile - 1) / kConvTile;
    const int64_t r0 = b / tcols * kConvTile, c0 = b % tcols * kConvTile;
    const int tx = threadIdx.x % kConvTile, ty = threadIdx.x / kConvTile;
    for (int i = ty; i < kConvTile; i += bt::kThreads / kConvTile) {
      const int64_t r = r0 + i, c = c0 + tx;
      tile[i][tx] = r < jb.rows && c < jb.cols ? bt::to_f(src[r * jb.cols + c]) : 0.f;
    }
    __syncthreads();
    for (int i = ty; i < kConvTile; i += bt::kThreads / kConvTile) {
      const int64_t c = c0 + i, r = r0 + tx;
      if (c < jb.cols && r < jb.rows) store1<P>(jb.dst + c * jb.rows + r, jb.lo, tile[tx][i]);
    }
    return;
  }
  const int64_t i = 2 * (b * bt::kThreads + threadIdx.x);
  if (i >= jb.rows * jb.cols) return;
  store2<P>(jb.dst + i, jb.lo, bt::to_f(src[i]), bt::to_f(src[i + 1]));
}

template <typename T, int P> cudaError_t convert(const ConvJobs& jobs, cudaStream_t stream) {
  operands_kernel<T, P><<<jobs.blocks(), bt::kThreads, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// One product of a jobs launch: out (+ z out_step for depth slice z =
// blockIdx.z) = A B over rows [0, m_end) and columns [0, n_end), depth
// [z k_per, min((z + 1) k_per, k_end)); m tiles of kTM rows.
struct ProductJob {
  Operand A, B;
  float* out;
  int64_t ldo, out_step, m_end;
  int n_end;
  int64_t k_end, k_per;
  unsigned mtiles;
};

// The body of a launch of two products: the first job's m tiles, then the
// second's, along blockIdx.y (one product: the same job twice).
template <bool AM, int BN, int P>
__device__ __forceinline__ void product_jobs(const ProductJob& j0, const ProductJob& j1) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const bool second = blockIdx.y >= j0.mtiles;
  const ProductJob jb = second ? j1 : j0;
  const int64_t m0 = (int64_t)(blockIdx.y - (second ? j0.mtiles : 0u)) * kTM;
  const int64_t k0 = (int64_t)blockIdx.z * jb.k_per;
  const int n0 = blockIdx.x * BN;
  float acc[2][BN / 16][4];
  product<AM, BN, P>(acc, jb.A, jb.B, m0, n0, k0, min(k0 + jb.k_per, jb.k_end), jb.m_end,
                         jb.n_end, reinterpret_cast<bf16*>(smem_b));
  store_product<BN>(acc, jb.out + blockIdx.z * jb.out_step, jb.ldo, 0, m0, n0, jb.m_end,
                    jb.n_end);
}

}  // namespace mm
}  // namespace
