// The frequency-axis roformer block's kernel, freq_block_kernel<C, T, TRAIN,
// STAGE> (its design: fused_freq.cu), with its shapes, weight slices and
// launch. STAGE cuts the eval block after a stage for the ablation bench
// (freq_ablate.cu, B13), on the same grid and 128-row tile as the whole
// block, which fused_freq.cu instantiates (K3, B6), at its blocks per SM:
//   kCopy  x into the float32 tile and out;
//   kRms   g = round_T(rmsnorm(x) gamma);
//   kQkv   q's columns of round_T(g W_qkv^T) before the rotation, k's and v's
//          computed and summed into a value nothing reaches (kNever), so
//          that the compiler keeps them;
//   kFF    x + FF(x): step 4 over x instead of y1;
//   kAttn  y1.
#pragma once

#include "small_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHD = bt::kHeadDim;                       // 32
constexpr int kWarps = 8;
constexpr int kTM = 16 * kWarps;                        // rows per block
constexpr int kNH = 32;                                 // hidden units per FF chunk
constexpr int kLDH = kHD + 8;                           // row stride of k and v (bf16)
constexpr float kQScale = 0.17677669529663688f * 1.4426950408889634f;  // 32^-0.5 log2(e)

// where the block is cut (the codes of bt_freq_ablate); kWhole is the block
enum Stage { kCopy, kRms, kQkv, kFF, kAttn, kWhole };

// A sum no input reaches: the qkv cut adds up the k and v products it does
// not write and stores the sum only if it equals this, so the compiler
// cannot drop them (a store under a launch argument does not keep them).
constexpr float kNever = 1.0e30f;

// Shapes of one instantiation: P parts per operand; the tile's row stride
// (floats: a multiple of 8 off a multiple of 32, so the float2 loads of a
// fragment's 8 rows hit distinct banks); a weight slice's elements per part
// (32 rows of C, or C rows of 32, at row stride + 8: the 8 rows an ldmatrix
// reads fall in distinct bank groups); shared-memory bytes.
template <int C, typename T, bool TRAIN> struct Shape {
  static constexpr int P = TRAIN ? mm::full_parts<T>() : mm::split_parts<T>();
  static constexpr int H = C / kHD;
  static constexpr int LDX = C + 8;
  static constexpr int SLICE = 32 * (C + 8) > C * (kHD + 8) ? 32 * (C + 8) : C * (kHD + 8);
  static constexpr int KV = P * kTM * kLDH;  // one of k, v: P parts
  static constexpr size_t SMEM =
      sizeof(float) * kTM * LDX + sizeof(bf16) * (2 * KV + 2 * P * SLICE);
};

// A fragments (P parts) of step k0 .. k0 + 15 of round_T((rows * rs) *
// gamma) for the warp's rows r0 + g and r0 + g + 8 of a float32 tile (row
// stride ld); rs: the two rows' norm scales.
template <typename T, int P>
__device__ __forceinline__ void a_from_rows(uint32_t (&a)[P][4], const float* xs, int ld, int r0,
                                            const float (&rs)[2],
                                            const float* __restrict__ gamma, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = k0 + 8 * half + 2 * t;
    const float2 gm = *reinterpret_cast<const float2*>(gamma + c);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 v = *reinterpret_cast<const float2*>(xs + (r0 + g + 8 * hh) * ld + c);
      st::set_parts<P>(a, 2 * half + hh, bt::round_to<T>(v.x * rs[hh] * gm.x),
                   bt::round_to<T>(v.y * rs[hh] * gm.y));
    }
  }
}

// The warp's 16 x 32 product g W^T for a staged slice w (32 rows of C, row
// stride C + 8) with g = round_T((tile rows * rs) * gamma): acc[j] holds
// output columns 8 j .. 8 j + 7.
template <int C, typename T, int P>
__device__ __forceinline__ void rows_product(float (&acc)[4][4], const float* xs, int r0,
                                             const float (&rs)[2],
                                             const float* __restrict__ gamma, const bf16* w,
                                             int lo) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < C; k0 += 16) {
    uint32_t a[P][4];
    a_from_rows<T, P>(a, xs, C + 8, r0, rs, gamma, k0);
#pragma unroll
    for (int np = 0; np < 2; ++np)
      st::mma_nt<P>(acc[2 * np], acc[2 * np + 1], a, w, lo, C + 8, np, k0);
  }
}

// acc (16 x C) += the warp's 16 x 32 operand a (two 16-deep steps) times a
// staged slice w (C rows of 32, row stride 40), transposed.
template <int C, int P>
__device__ __forceinline__ void slice_product(float (&acc)[C / 8][4], const uint32_t (&a)[P][2][4],
                                              const bf16* w, int lo) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t ak[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) ak[p][i] = a[p][kk][i];
#pragma unroll
    for (int np = 0; np < C / 16; ++np)
      st::mma_nt<P>(acc[2 * np], acc[2 * np + 1], ak, w, lo, kHD + 8, np, 16 * kk);
  }
}

// RoPE at position pos on the rotation pairs of C fragments s (columns 8 j +
// 2 t, + 1 of a head) in row half hh: values rounded to T, rotated, rounded.
template <typename T>
__device__ __forceinline__ void rope_frags(float (&s)[4][4], int hh, int pos,
                                           const float* __restrict__ cosv,
                                           const float* __restrict__ sinv) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int at = pos * (kHD / 2) + 4 * j + t;
    const float cs = cosv[at], sn = sinv[at];
    const float a = bt::round_to<T>(s[j][2 * hh]), b = bt::round_to<T>(s[j][2 * hh + 1]);
    s[j][2 * hh] = bt::round_to<T>(a * cs - b * sn);
    s[j][2 * hh + 1] = bt::round_to<T>(b * cs + a * sn);
  }
}

// The block's weights and the slices they are staged in: per head the q, k
// and v rows of W_qkv and the head's columns of W_out, then per chunk of
// kNH hidden units those rows of W1 and columns of W2. A cut stages only
// the slices it uses: kQkv the q, k and v rows of each head, kFF the FF's,
// kAttn the attention's.
template <int C, typename T, int STAGE = kWhole> struct Weights {
  const T *wqkv, *wout, *w1, *w2;
  int M;

  __device__ __forceinline__ int count() const {
    if constexpr (STAGE == kQkv) return 3 * (C / kHD);
    if constexpr (STAGE == kFF) return 2 * (M / kNH);
    if constexpr (STAGE == kAttn) return 4 * (C / kHD);
    return 4 * (C / kHD) + 2 * (M / kNH);
  }

  // slice s: its first element, its matrix's row stride, and whether it is
  // 32 rows of C (else C rows of 32)
  __device__ __forceinline__ const T* at(int s, int& ld, bool& wide) const {
    constexpr int H = C / kHD;
    if constexpr (STAGE == kQkv) s = 4 * (s / 3) + s % 3;
    if constexpr (STAGE == kFF) s += 4 * H;
    if (s < 4 * H) {
      const int h = s >> 2, kind = s & 3;
      ld = C;
      wide = kind < 3;
      return wide ? wqkv + (size_t)(kind * C + h * kHD) * C : wout + h * kHD;
    }
    const int u = s - 4 * H, ch = u >> 1;
    wide = !(u & 1);
    ld = wide ? C : M;
    return wide ? w1 + (size_t)ch * kNH * C : w2 + ch * kNH;
  }
};

// The slices through two buffers of shared memory (`wb`, P parts `lo`
// apart each), one in registers on its way there, 16 bytes of T a chunk:
// read() loads slice s, write() stores it as P bf16 parts (float32 split as
// it is stored) at row stride (columns + 8). begin() reads the next slice,
// waits until every warp is done with the buffer it goes to (which also
// makes the block's last writes to k, v and the tile visible) and returns
// the current one; finish() stores the next one and moves on.
template <int C, typename T, int P> struct Stager {
  static constexpr int kPer = 16 / sizeof(T);  // elements per chunk
  static constexpr int kChunks = 32 * C / kPer;
  static constexpr int kReg = (kChunks + bt::kThreads - 1) / bt::kThreads;
  uint4 v[kReg];
  int ld;
  bool wide;

  template <typename Ws> __device__ __forceinline__ void read(const Ws& W, int s) {
    const T* base = W.at(s, ld, wide);
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int e = threadIdx.x + i * bt::kThreads;
      if (kChunks % bt::kThreads == 0 || e < kChunks) {
        const int per_row = (wide ? C : kHD) / kPer;
        const int r = e / per_row, c = (e % per_row) * kPer;
        v[i] = *reinterpret_cast<const uint4*>(base + (size_t)r * ld + c);
      }
    }
  }

  template <typename Ws>
  __device__ __forceinline__ const bf16* begin(const Ws& W, int s, bf16* wb, int lo) {
    if (s + 1 < W.count()) read(W, s + 1);
    __syncthreads();
    return wb + (s & 1) * P * lo;
  }

  template <typename Ws>
  __device__ __forceinline__ void finish(const Ws& W, int& s, bf16* wb, int lo) {
    if (s + 1 < W.count()) write(wb + ((s + 1) & 1) * P * lo, lo);
    ++s;
  }

  __device__ __forceinline__ void write(bf16* dst, int lo) const {
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int e = threadIdx.x + i * bt::kThreads;
      if (!(kChunks % bt::kThreads == 0 || e < kChunks)) continue;
      const int cols = wide ? C : kHD, per_row = cols / kPer;
      const int r = e / per_row, c = (e % per_row) * kPer;
      bf16* p = dst + r * (cols + 8) + c;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(p) = v[i];
      } else {
        float f[4] = {__uint_as_float(v[i].x), __uint_as_float(v[i].y), __uint_as_float(v[i].z),
                      __uint_as_float(v[i].w)};
#pragma unroll
        for (int q = 0; q < P; ++q) {
          uint2 w;
          w.x = bt::pack_bf16(f[0], f[1]);
          w.y = bt::pack_bf16(f[2], f[3]);
          *reinterpret_cast<uint2*>(p + q * lo) = w;
          if (q + 1 < P) {
            const float2 a = bt::unpack_bf16(w.x), b = bt::unpack_bf16(w.y);
            f[0] -= a.x, f[1] -= a.y, f[2] -= b.x, f[3] -= b.y;
          }
        }
      }
    }
  }
};

template <int C, typename T, bool TRAIN, int STAGE = kWhole>
__global__ void __launch_bounds__(bt::kThreads, 1)
    freq_block_kernel(const T* __restrict__ x, const float* __restrict__ agamma,
                      const T* __restrict__ wqkv, const float* __restrict__ wg,
                      const float* __restrict__ gb, const T* __restrict__ wout,
                      const float* __restrict__ fgamma, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ cosv,
                      const float* __restrict__ sinv, T* __restrict__ out, int64_t rows, int F,
                      int M, bt::Dropout drop) {
  static_assert(STAGE == kWhole || !TRAIN, "the cuts are of the eval block");
  constexpr bool kAttnPart = STAGE == kAttn || STAGE == kWhole;  // the attention branch
  constexpr bool kFFPart = STAGE == kFF || STAGE == kWhole;      // the feed-forward
  constexpr bool kWeighted = STAGE != kCopy && STAGE != kRms;
  using S = Shape<C, T, TRAIN>;
  constexpr int P = S::P, H = S::H, LDX = S::LDX, NJ = C / 8;
  extern __shared__ __align__(16) unsigned char smem_b[];
  float* xs = reinterpret_cast<float*>(smem_b);
  bf16* ks = reinterpret_cast<bf16*>(xs + kTM * LDX);
  bf16* vs = ks + S::KV;
  bf16* wb = vs + S::KV;  // two slices of P parts
  constexpr int kvlo = kTM * kLDH, wlo = S::SLICE;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int rw = 16 * warp;             // the warp's first row in the tile
  const int grp = rw & ~31;             // its 32-row group's first row
  const int64_t row0 = (int64_t)blockIdx.x * kTM;
  const int nrows = (int)min((int64_t)kTM, rows - row0);
  const int64_t wrow = row0 + rw + g;   // global row of this lane's first fragment row
  const float sc = sqrtf((float)C);

  const Weights<C, T, STAGE> W{wqkv, wout, w1, w2, M};
  Stager<C, T, P> st;
  if constexpr (kWeighted) st.read(W, 0);

  // x into the tile, zeros past the last row
  for (int e = threadIdx.x; e < kTM * C / 4; e += bt::kThreads) {
    const int r = e / (C / 4), c = 4 * (e % (C / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) {
      const T* p = x + (row0 + r) * C + c;
      if constexpr (sizeof(T) == 4) {
        v = *reinterpret_cast<const float4*>(p);
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        const float2 a = bt::unpack_bf16(u.x), b = bt::unpack_bf16(u.y);
        v = make_float4(a.x, a.y, b.x, b.y);
      }
    }
    *reinterpret_cast<float4*>(xs + r * LDX + c) = v;
  }
  if constexpr (kWeighted) st.write(wb, wlo);
  __syncthreads();

  // the rows' norms and gates, from the lanes that hold their fragments
  float rs[2], gate[2][H];
  if constexpr (STAGE != kCopy && STAGE != kFF) {
    float ss[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 v = *reinterpret_cast<const float2*>(xs + (rw + g + 8 * hh) * LDX + 8 * j + 2 * t);
        ss[hh] += v.x * v.x + v.y * v.y;
      }
    float z[2][H] = {};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) rs[hh] = sc / fmaxf(sqrtf(tc::quad_sum(ss[hh])), 1e-12f);
#pragma unroll
    for (int j = 0; j < NJ && kAttnPart; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 gm = *reinterpret_cast<const float2*>(agamma + c);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 v = *reinterpret_cast<const float2*>(xs + (rw + g + 8 * hh) * LDX + c);
        const float g0 = bt::round_to<T>(v.x * rs[hh] * gm.x);
        const float g1 = bt::round_to<T>(v.y * rs[hh] * gm.y);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float2 w = *reinterpret_cast<const float2*>(wg + h * C + c);
          z[hh][h] += g0 * w.x + g1 * w.y;
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2 && kAttnPart; ++hh)
#pragma unroll
      for (int h = 0; h < H; ++h)
        gate[hh][h] = bt::round_to<T>(1.f / (1.f + expf(-(tc::quad_sum(z[hh][h]) + gb[h]))));
    if constexpr (STAGE == kRms) {  // g over x in the warp's rows of the tile
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 gm = *reinterpret_cast<const float2*>(agamma + 8 * j + 2 * t);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2* p = reinterpret_cast<float2*>(xs + (rw + g + 8 * hh) * LDX + 8 * j + 2 * t);
          const float2 v = *p;
          *p = make_float2(bt::round_to<T>(v.x * rs[hh] * gm.x),
                           bt::round_to<T>(v.y * rs[hh] * gm.y));
        }
      }
    }
  }

  int s = 0;  // the slice in use
  float y[NJ][4] = {};  // the attention branch over the heads, then out's sum
  if constexpr (STAGE == kQkv) {  // q's columns into y, k's and v's into the sink
    float unkept = 0.f;
    for (int h = 0; h < H; ++h)
#pragma unroll 1
      for (int kind = 0; kind < 3; ++kind) {
        const bf16* w = st.begin(W, s, wb, wlo);
        float acc[4][4];
        rows_product<C, T, P>(acc, xs, rw, rs, agamma, w, wlo);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int x4 = 0; x4 < 4; ++x4) {
            if (kind > 0) {
              unkept += acc[j][x4];
            } else {
#pragma unroll
              for (int i = 0; i < H; ++i)
                if (i == h) y[4 * i + j][x4] = bt::round_to<T>(acc[j][x4]);
            }
          }
        st.finish(W, s, wb, wlo);
      }
    if (unkept == kNever) out[row0 * C] = bt::from_f<T>(unkept);
  }
  for (int h = 0; h < H && kAttnPart; ++h) {
    float gt[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      gt[hh] = gate[hh][0];
#pragma unroll
      for (int i = 1; i < H; ++i)
        if (i == h) gt[hh] = gate[hh][i];
    }
    uint32_t qa[P][2][4];
#pragma unroll 1
    for (int kind = 0; kind < 3; ++kind) {  // q, k, v
      const bf16* w = st.begin(W, s, wb, wlo);
      float acc[4][4];
      rows_product<C, T, P>(acc, xs, rw, rs, agamma, w, wlo);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (kind < 2) {
          rope_frags<T>(acc, hh, (rw + g + 8 * hh) % F, cosv, sinv);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[j][2 * hh] = bt::round_to<T>(acc[j][2 * hh]);
            acc[j][2 * hh + 1] = bt::round_to<T>(acc[j][2 * hh + 1]);
          }
        }
      }
      if (kind == 0) {
        st::frags_to_a<P, 2>(qa, acc);
      } else {
        bf16* dst = kind == 1 ? ks : vs;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            mm::store2<P>(dst + (rw + g + 8 * hh) * kLDH + 8 * j + 2 * t, kvlo, acc[j][2 * hh],
                          acc[j][2 * hh + 1]);
      }
      st.finish(W, s, wb, wlo);
    }

    const bf16* w = st.begin(W, s, wb, wlo);  // W_out's columns of head h; k and v are in place
    // scores of the warp's 16 queries against the 32 keys of their group
    float sc4[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sc4[j][0] = sc4[j][1] = sc4[j][2] = sc4[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ak[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) ak[p][i] = qa[p][kk][i];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        st::mma_nt<P>(sc4[2 * np], sc4[2 * np + 1], ak, ks + grp * kLDH, kvlo, kLDH, np, 16 * kk);
    }
    const int qb = rw - grp;  // the warp's first query in the group
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * j + 2 * t + e;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (key / F == (qb + g + 8 * hh) / F) m[hh] = fmaxf(m[hh], sc4[j][2 * hh + e]);
      }
    // scaling is monotonic: the maximum of the scaled scores
    m[0] = tc::quad_max(m[0]) * kQScale;
    m[1] = tc::quad_max(m[1]) * kQScale;
    uint32_t bits[2] = {0u, 0u};
    if constexpr (TRAIN)
      if (drop.on) {
        const int ql = st::draw_row(qb);
        st::prob_bits<32>(drop, ql, (uint32_t)((row0 + grp + ql) / F), (uint32_t)h, F, bits);
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * j + 2 * t + e;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const bool in = key / F == (qb + g + 8 * hh) / F;
          const float p = in ? exp2f(sc4[j][2 * hh + e] * kQScale - m[hh]) : 0.f;
          l[hh] += p;
          float pd = p;
          if constexpr (TRAIN)
            if (drop.on) pd = (bits[hh] >> (2 * j + e)) & 1u ? p * drop.scale : 0.f;
          sc4[j][2 * hh + e] = pd;
        }
      }
    // o = round_T(P V / l), go = round_T(o gate) as A fragments
    float o[4][4];
    {
      uint32_t pa[P][2][4];
      st::frags_to_a<P, 2>(pa, sc4);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ak[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int i = 0; i < 4; ++i) ak[p][i] = pa[p][kk][i];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          st::mma_nn<P>(o[2 * c], o[2 * c + 1], ak, vs + grp * kLDH, kvlo, kLDH, 16 * kk, 16 * c);
      }
    }
    const float lt[2] = {tc::quad_sum(l[0]), tc::quad_sum(l[1])};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[j][2 * hh + e] =
              bt::round_to<T>(bt::round_to<T>(o[j][2 * hh + e] / lt[hh]) * gt[hh]);
    uint32_t ga[P][2][4];
    st::frags_to_a<P, 2>(ga, o);
    slice_product<C, P>(y, ga, w, wlo);
    st.finish(W, s, wb, wlo);
  }

  // y1 = x + drop(branch) over x in the tile, and the rows' norms for the FF
  // (kFF: of x; kQkv: q over x)
  float rf[2];
  if constexpr (kWeighted) {
    float ss[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float f[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
      if constexpr (TRAIN) mm::row_keep(drop, bt::kSiteAttnOut, wrow, 8 * j, f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float2* p = reinterpret_cast<float2*>(xs + (rw + g + 8 * hh) * LDX + 8 * j + 2 * t);
        float2 v = *p;
        if constexpr (kAttnPart) {
          v.x += y[j][2 * hh] * f[hh][0];
          v.y += y[j][2 * hh + 1] * f[hh][1];
          *p = v;
        } else if constexpr (STAGE == kQkv) {
          *p = make_float2(y[j][2 * hh], y[j][2 * hh + 1]);
        }
        ss[hh] += v.x * v.x + v.y * v.y;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) rf[hh] = sc / fmaxf(sqrtf(tc::quad_sum(ss[hh])), 1e-12f);
  }
  __syncwarp();

  // the feed-forward, kNH hidden units a chunk
#pragma unroll
  for (int j = 0; j < NJ; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
  for (int c0 = 0; c0 < M && kFFPart; c0 += kNH) {
    uint32_t ha[P][2][4];
    {
      const bf16* w = st.begin(W, s, wb, wlo);
      float acc[4][4];
      rows_product<C, T, P>(acc, xs, rw, rf, fgamma, w, wlo);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
        if constexpr (TRAIN) mm::row_keep(drop, bt::kSiteFFHidden, wrow, c0 + 8 * j, f);
        const float2 bb = *reinterpret_cast<const float2*>(b1 + c0 + 8 * j + 2 * t);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          acc[j][2 * hh] = bt::gelu_exact(acc[j][2 * hh] + bb.x) * f[hh][0];
          acc[j][2 * hh + 1] = bt::gelu_exact(acc[j][2 * hh + 1] + bb.y) * f[hh][1];
        }
      }
      st::frags_to_a<P, 2>(ha, acc);  // part 0 is round_T(h)
      st.finish(W, s, wb, wlo);
    }
    const bf16* w = st.begin(W, s, wb, wlo);
    slice_product<C, P>(y, ha, w, wlo);
    st.finish(W, s, wb, wlo);
  }

  // out = round_T(y1 + drop(ff + b2)), through the warp's rows of the tile
#pragma unroll
  for (int j = 0; j < NJ && kFFPart; ++j) {
    float f[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
    if constexpr (TRAIN) mm::row_keep(drop, bt::kSiteFFOut, wrow, 8 * j, f);
    const float2 bb = *reinterpret_cast<const float2*>(b2 + 8 * j + 2 * t);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float2* p = reinterpret_cast<float2*>(xs + (rw + g + 8 * hh) * LDX + 8 * j + 2 * t);
      float2 v = *p;
      v.x += (y[j][2 * hh] + bb.x) * f[hh][0];
      v.y += (y[j][2 * hh + 1] + bb.y) * f[hh][1];
      *p = v;
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * C / 4; e += 32) {
    const int r = rw + e / (C / 4), c = 4 * (e % (C / 4));
    if (r >= nrows) continue;
    const float4 v = *reinterpret_cast<const float4*>(xs + r * LDX + c);
    T* p = out + (row0 + r) * C + c;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = v;
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(bt::pack_bf16(v.x, v.y), bt::pack_bf16(v.z, v.w));
    }
  }
}

// Blocks of freq_block_kernel<C, T, TRAIN, STAGE> an SM holds with `smem`
// bytes of dynamic shared memory.
template <int C, typename T, bool TRAIN, int STAGE = kWhole>
cudaError_t blocks_per_sm(int* blocks, size_t smem = Shape<C, T, TRAIN>::SMEM) {
  auto kernel = freq_block_kernel<C, T, TRAIN, STAGE>;
  cudaError_t err = bt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, bt::kThreads, smem);
}

// smem: the dynamic shared memory, Shape's size or more (a cut held to the
// whole block's blocks per SM, freq_ablate.cu).
template <int C, typename T, bool TRAIN, int STAGE = kWhole>
cudaError_t launch(const void* x, const void* agamma, const void* wqkv, const void* wg,
                   const void* gb, const void* wout, const void* fgamma, const void* w1,
                   const void* b1, const void* w2, const void* b2, const void* cosv,
                   const void* sinv, void* out, int64_t rows, int F, int M, bt::Dropout drop,
                   cudaStream_t stream, size_t smem = Shape<C, T, TRAIN>::SMEM) {
  auto kernel = freq_block_kernel<C, T, TRAIN, STAGE>;
  cudaError_t err = bt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((rows + kTM - 1) / kTM);
  kernel<<<blocks, bt::kThreads, smem, stream>>>(
      (const T*)x, (const float*)agamma, (const T*)wqkv, (const float*)wg, (const float*)gb,
      (const T*)wout, (const float*)fgamma, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (const float*)cosv, (const float*)sinv, (T*)out, rows, F, M, drop);
  return cudaGetLastError();
}

}  // namespace
