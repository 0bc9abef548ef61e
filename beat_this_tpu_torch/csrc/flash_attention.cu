// Softmax attention over (bh, n, D) with the rotation of q and k inside,
// forward and backward:
//   o = drop_p(softmax(rope(q) rope(k)^T D^-0.5)) v     per leading entry,
// with a softmax in base 2 (the factor D^-0.5 log2(e) is folded into q
// before q is rounded to the input type), dropout on the probabilities
// drawn from Philox (philox.cuh) by the coordinates (bh / heads, bh % heads,
// query, key), the normalizer summed over the undropped p, and optionally
// the base-2 log-sum-exp lse = m + log2(l) per query for the backward.
//
// Replaces beat_this_tpu/ops/flash_attention.py:_flash_kernel and
// :_flash_kernel_lse (forward, shared body _flash_fwd_body) and
// :_flash_dq_kernel / :_flash_dkv_kernel (backward). The TPU kernels pad n
// to multiples of 128, hold whole (block_q, block_k) score tiles and rotate
// with a (D, D) matrix product.
//
// One design for both dtypes, on the tensor cores: mma.sync m16n8k16, bf16
// operands, float32 accumulators (mma.cuh). An operand has P bf16 parts
// (attn_tc.cuh): bfloat16 one, itself; float32 three in the forward (the six
// products of parts i, j with i + j <= 2, each k-step summed apart: float32's
// own 24 bits, which the forward's 1e-5 limits need; two parts miss them)
// and two in the backward (three products, about 16 bits, within its 1e-4
// limit: tests/test_torch_flash_f32_design.py). A pre-pass writes rotated,
// scaled q and rotated k to scratch as P parts each, and with P > 1 also v
// (and dout in the backward), so no block rotates or splits a tile again. A
// block is 4 warps; each warp owns 16 rows (queries; dkv: keys) whose
// operand fragments stay in registers, over 64-row tiles of the other side
// staged by cp.async through a 3-deep ring in shared memory and read by
// ldmatrix (the tile and its helpers live in attn_tc.cuh, shared with the
// time-axis kernels).
//   flash_fwd: two walks over the keys. The first computes S = Q K^T from
//     the first parts alone and each row's maximum m (quad shuffles); the
//     second S again from every part, p = exp2(s - m), dropout bits (one
//     Philox group of 4 keys spans two lanes: the even lane draws row g's
//     groups, the odd lane row g + 8's, and they trade by one shuffle), p f
//     repacked from the C fragments into A fragments of P parts (bf16:
//     rounded), O += P V with V by ldmatrix.trans. In bf16 p is thus
//     rounded relative to the row's true maximum, as in the plain version,
//     and no accumulator is ever rescaled. In float32 nothing is rounded, so
//     m need not be the exact maximum: o = sum(p f v) / sum(p) and lse = m +
//     log2(sum(p)) are the same for any m near it.
//   flash_dq:  S = Q K^T and dP = dO V^T; dS = ln 2 P (dP f - delta), the
//     gradient of the base-2 scores, in parts (bf16: rounded where the plain
//     version's autograd rounds it); dQ += dS K; the inverse rotation times
//     D^-0.5 log2(e), the factor folded into q.
//   flash_dkv: S^T = K Q^T and dP^T = V dO^T over query tiles of the
//     forward's q; dV += (P^T f) dO, dK += dS^T Q (Q scaled already); the
//     inverse rotation. The mask bits of a 4-key group lie across rows of
//     S^T, so the block draws them into a shared bit table.
// dk and dv reduce over queries, so they get their key-major pass and no
// float atomics: two runs give the same bits. delta = rowsum(do * o) comes
// from the caller, as on the TPU.
//
// flash_fwd_kernel also carries the ablation modes of
// tools/bench_flash_ablate.py:make_kernel (bt_flash_ablate): the forward with
// parts left out, to see where its time goes. kNoRope takes q and k as they
// are (no rotation, no scale; bf16: no pre-pass); kNoExp sets p = s and l =
// sum(s), with no running maximum at all; kMatmulOnly adds round_T(s) v and
// divides by the number of key blocks the caller names. Each is a
// compile-time branch, so the full mode's code is the kernel the model runs.
//
// Bound on the H100: arithmetic, against O(n D) bytes. Products: 4 n^2 D
// multiply-adds per entry forward, 10 n^2 D backward, at 989 TFLOP/s in bf16
// and 989 / 3 in float32 (three bf16 products a product; the forward's six
// and its bf16 first walk take more). Per score also one MUFU exp2 (16 a
// clock per SM) and, with dropout, one Philox call per 4 scores (10 rounds of
// 32-bit multiplies): at D = 16 these weigh as much as the products.
#include <type_traits>

#include "attn_tc.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
// ablation modes of the forward (kFull is the kernel the model runs)
constexpr int kFull = 0, kNoRope = 1, kNoExp = 2, kMatmulOnly = 3;

namespace tc {

// Operand parts by dtype: bf16 one; float32 three in the forward, two in the
// backward (see above).
template <typename T> __host__ __device__ constexpr int fwd_parts() {
  return std::is_same<T, float>::value ? 3 : 1;
}
template <typename T> __host__ __device__ constexpr int bwd_parts() {
  return std::is_same<T, float>::value ? 2 : 1;
}

// The pre-pass over bh * n rows of D (row r at position r % n), one channel
// pair per thread and step: qr = rope(q) * qmul and kr = rope(k) as P parts
// each (`lo` elements apart); with P > 1 also v and, unless null, dout; null
// tables: no rotation.
template <int D, typename T, int P>
__global__ void __launch_bounds__(256)
    rotate_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ cosv,
                  const float* __restrict__ sinv, bf16* __restrict__ qr, bf16* __restrict__ kr,
                  bf16* __restrict__ vr, bf16* __restrict__ dr, int64_t lo, int64_t pairs, int n,
                  float qmul) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < pairs;
       e += (int64_t)gridDim.x * blockDim.x) {
    float cs = 1.f, sn = 0.f;
    if (cosv != nullptr) {
      const size_t at = (size_t)((e / (D / 2)) % n) * (D / 2) + e % (D / 2);
      cs = cosv[at];
      sn = sinv[at];
    }
    const float2 a = load_pair(q, e), b = load_pair(k, e);
    mm::store2<P>(qr + 2 * e, lo, (a.x * cs - a.y * sn) * qmul, (a.y * cs + a.x * sn) * qmul);
    mm::store2<P>(kr + 2 * e, lo, b.x * cs - b.y * sn, b.y * cs + b.x * sn);
    if constexpr (P > 1) {
      const float2 c = load_pair(v, e);
      mm::store2<P>(vr + 2 * e, lo, c.x, c.y);
      if (dout != nullptr) {
        const float2 d = load_pair(dout, e);
        mm::store2<P>(dr + 2 * e, lo, d.x, d.y);
      }
    }
  }
}

// The forward over pre-rotated parts qr, kr and v (see MODE above; bf16:
// v in place); `blocks` is kMatmulOnly's denominator, `lse` gets kNoExp's
// denominator l. Tiles stream through kStages buffers: tile it + kStages - 1
// is staged while tile it is used, and the one barrier per tile both
// publishes tile it and frees the buffer the next copy overwrites.
template <int D, typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ qr, const bf16* __restrict__ kr,
                     const bf16* __restrict__ v, int64_t lo, T* __restrict__ o,
                     float* __restrict__ lse, int n, int heads, bt::Dropout drop, float blocks) {
  constexpr int P = fwd_parts<T>();
  constexpr bool kSoftmax = MODE == kFull || MODE == kNoRope;
  extern __shared__ __align__(16) unsigned char smem_b[];
  Tile<D>* ks = reinterpret_cast<Tile<D>*>(smem_b);  // [kStages][P]
  Tile<D>* vs = ks + kStages * P;
  const int bh = blockIdx.x, item = bh / heads, h = bh % heads;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kRows + 16 * (threadIdx.x >> 5);
  const size_t base = (size_t)bh * n * D;
  const int tiles = (n + kTile - 1) / kTile;
  uint32_t qa[P][D / 16][4];
  load_parts<D, P>(qa, qr + base, lo, row0, n);
  float m[2] = {-INFINITY, -INFINITY};
  if constexpr (kSoftmax) {  // walk 1: the row maxima, from the first parts
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < tiles) stage<D>(ks[st * P], kr + base, st * kTile, n);
      bt::cp_async_commit();
    }
    for (int it = 0; it < tiles; ++it) {
      const int k0 = it * kTile;
      bt::cp_async_wait<kStages - 2>();
      __syncthreads();
      if (it + kStages - 1 < tiles)
        stage<D>(ks[((it + kStages - 1) % kStages) * P], kr + base, k0 + (kStages - 1) * kTile, n);
      bt::cp_async_commit();
      float s[8][4];
      product_nt<D>(s, qa[0], ks[(it % kStages) * P]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * j + 2 * t + e < n) {
            m[0] = fmaxf(m[0], s[j][e]);
            m[1] = fmaxf(m[1], s[j][2 + e]);
          }
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    bt::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the buffers walk 2 restages
  }
  // walk 2: p, l and O += P V
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) {
      stage_parts<D, P>(ks + st * P, kr + base, lo, st * kTile, n);
      stage_parts<D, P>(vs + st * P, v + base, lo, st * kTile, n);
    }
    bt::cp_async_commit();
  }
  float acc[D / 8][4] = {};
  float l[2] = {0.f, 0.f};
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile, buf = it % kStages;
    bt::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < tiles) {
      const int nb = (it + kStages - 1) % kStages;
      stage_parts<D, P>(ks + nb * P, kr + base, lo, k0 + (kStages - 1) * kTile, n);
      stage_parts<D, P>(vs + nb * P, v + base, lo, k0 + (kStages - 1) * kTile, n);
    }
    bt::cp_async_commit();
    float s[8][4];
    scores<D, P>(s, qa, ks + buf * P);
    if constexpr (kSoftmax) {
      uint32_t bits[2] = {0u, 0u};
      if (drop.on) keep_bits(drop, item, h, row0 + g, k0, bits);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = k0 + 8 * j + 2 * t + e < n;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float p = in ? fast_exp2(s[j][2 * hh + e] - m[hh]) : 0.f;
            l[hh] += p;
            s[j][2 * hh + e] = drop.on ? p * keep_factor(drop, bits[hh], 2 * j + e) : p;
          }
        }
    } else if constexpr (MODE == kNoExp) {
      // no softmax: the scores themselves weigh v (keys past n staged as zeros)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l[hh] += s[j][2 * hh] + s[j][2 * hh + 1];
    }
    uint32_t pa[P][4][4];
    to_parts<P>(pa, s);
    accumulate<D, P>(acc, pa, vs + buf * P);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = MODE == kMatmulOnly ? blocks : quad_sum(l[hh]);
    const int r = row0 + g + 8 * hh;
    if (r >= n) continue;
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * n + r] = MODE == kNoExp ? l[hh] : m[hh] + log2f(l[hh]);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      store_pair(o + base + (size_t)r * D + 8 * c + 2 * t, acc[c][2 * hh] / l[hh],
                 acc[c][2 * hh + 1] / l[hh]);
  }
}

// g (the rotation pair i = 4c + t of row r, channels 8c + 2t, +1) pulled
// back through the rotation at position r, times mul, stored as T.
template <typename T>
__device__ __forceinline__ void store_rope_inv(T* dst, float a, float b,
                                               const float* __restrict__ cosv,
                                               const float* __restrict__ sinv, size_t at,
                                               float mul) {
  const float cs = cosv == nullptr ? 1.f : cosv[at];
  const float sn = cosv == nullptr ? 0.f : sinv[at];
  store_pair(dst, (a * cs + b * sn) * mul, (b * cs - a * sn) * mul);
}

// qr, kr, v and dout: the backward's parts (bf16: v and dout in place).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const bf16* __restrict__ qr, const bf16* __restrict__ kr,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout, int64_t lo,
                    const float* __restrict__ cosv, const float* __restrict__ sinv,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq_out, int n, int heads, bt::Dropout drop) {
  constexpr int P = bwd_parts<T>();
  extern __shared__ __align__(16) unsigned char smem_b[];
  Tile<D>* ks = reinterpret_cast<Tile<D>*>(smem_b);  // [kStages][P]
  Tile<D>* vs = ks + kStages * P;
  const int bh = blockIdx.x, item = bh / heads, h = bh % heads;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kRows + 16 * (threadIdx.x >> 5);
  const size_t base = (size_t)bh * n * D;
  const int tiles = (n + kTile - 1) / kTile;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) {
      stage_parts<D, P>(ks + st * P, kr + base, lo, st * kTile, n);
      stage_parts<D, P>(vs + st * P, v + base, lo, st * kTile, n);
    }
    bt::cp_async_commit();
  }
  uint32_t qa[P][D / 16][4], da[P][D / 16][4];
  load_parts<D, P>(qa, qr + base, lo, row0, n);
  load_parts<D, P>(da, dout + base, lo, row0, n);
  float ls[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + g + 8 * hh;
    ls[hh] = r < n ? lse[(size_t)bh * n + r] : 0.f;
    dl[hh] = r < n ? delta[(size_t)bh * n + r] : 0.f;
  }
  float acc[D / 8][4] = {};
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile, buf = it % kStages;
    bt::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < tiles) {
      const int nb = (it + kStages - 1) % kStages;
      stage_parts<D, P>(ks + nb * P, kr + base, lo, k0 + (kStages - 1) * kTile, n);
      stage_parts<D, P>(vs + nb * P, v + base, lo, k0 + (kStages - 1) * kTile, n);
    }
    bt::cp_async_commit();
    float s[8][4], dp[8][4];
    scores<D, P>(s, qa, ks + buf * P);
    scores<D, P>(dp, da, vs + buf * P);
    uint32_t bits[2] = {0u, 0u};
    if (drop.on) keep_bits(drop, item, h, row0 + g, k0, bits);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 2 * hh + e;
          const float p = k0 + 8 * j + 2 * t + e < n ? fast_exp2(s[j][x] - ls[hh]) : 0.f;
          const float f = drop.on ? keep_factor(drop, bits[hh], 2 * j + e) : 1.f;
          s[j][x] = kLn2 * p * (dp[j][x] * f - dl[hh]);  // dS, in parts by to_parts
        }
    uint32_t pa[P][4][4];
    to_parts<P>(pa, s);
    accumulate<D, P>(acc, pa, ks + buf * P);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + g + 8 * hh;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      store_rope_inv(dq_out + base + (size_t)r * D + 8 * c + 2 * t, acc[c][2 * hh],
                     acc[c][2 * hh + 1], cosv, sinv, (size_t)r * (D / 2) + 4 * c + t,
                     bt::qscale<D>());
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const bf16* __restrict__ qr, const bf16* __restrict__ kr,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout, int64_t lo,
                     const float* __restrict__ cosv, const float* __restrict__ sinv,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk_out, T* __restrict__ dv_out, int n, int heads,
                     bt::Dropout drop) {
  constexpr int P = bwd_parts<T>();
  extern __shared__ __align__(16) unsigned char smem_b[];
  Tile<D>* qs = reinterpret_cast<Tile<D>*>(smem_b);  // the forward's rotated, scaled q
  Tile<D>* dos = qs + kStages * P;                    // the cotangent rows
  float* lss = reinterpret_cast<float*>(dos + kStages * P);  // [kStages][kTile] lse
  float* dls = lss + kStages * kTile;                         // [kStages][kTile] delta
  // mask bits of 4 keys per byte, by tile parity
  auto* keepb = reinterpret_cast<uint8_t(*)[kTile][kRows / 4]>(dls + kStages * kTile);
  const int bh = blockIdx.x, item = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kb0 = blockIdx.y * kRows, row0 = kb0 + 16 * warp;
  const size_t base = (size_t)bh * n * D;
  const float* lrow = lse + (size_t)bh * n;
  const float* drow = delta + (size_t)bh * n;
  const int tiles = (n + kTile - 1) / kTile;
  // stages tile `st` (queries st * kTile ...) into buffer st % kStages
  auto stage_tile = [&](int st) {
    const int b = st % kStages, q0 = st * kTile;
    stage_parts<D, P>(qs + b * P, qr + base, lo, q0, n);
    stage_parts<D, P>(dos + b * P, dout + base, lo, q0, n);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      lss[b * kTile + i] = q0 + i < n ? lrow[q0 + i] : 0.f;
      dls[b * kTile + i] = q0 + i < n ? drow[q0 + i] : 0.f;
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) stage_tile(st);
    bt::cp_async_commit();
  }
  if (drop.on) keep_table(keepb[0], drop, item, h, kb0, 0);
  uint32_t ka[P][D / 16][4], va[P][D / 16][4];
  load_parts<D, P>(ka, kr + base, lo, row0, n);
  load_parts<D, P>(va, v + base, lo, row0, n);
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int it = 0; it < tiles; ++it) {
    const int q0 = it * kTile, buf = it % kStages;
    bt::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < tiles) stage_tile(it + kStages - 1);
    bt::cp_async_commit();
    // the next tile's bits into the table the previous tile used
    if (drop.on && it + 1 < tiles) keep_table(keepb[(it + 1) & 1], drop, item, h, kb0, q0 + kTile);
    float s[8][4], dp[8][4];
    scores<D, P>(s, ka, qs + buf * P);    // S^T: the warp's 16 keys x 64 queries
    scores<D, P>(dp, va, dos + buf * P);  // dP^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * j + 2 * t + e;
        const bool in = q0 + qi < n;
        const float lq = lss[buf * kTile + qi], dq = dls[buf * kTile + qi];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 2 * hh + e, kl = 16 * warp + g + 8 * hh;
          const float p = in ? fast_exp2(s[j][x] - lq) : 0.f;
          const float f = !drop.on                                          ? 1.f
                          : ((keepb[it & 1][qi][kl >> 2] >> (kl & 3)) & 1) ? drop.scale
                                                                            : 0.f;
          s[j][x] = p * f;                     // P^T f, in parts by to_parts
          dp[j][x] = kLn2 * p * (dp[j][x] * f - dq);  // dS^T, in parts by to_parts
        }
      }
    uint32_t pa[P][4][4];
    to_parts<P>(pa, s);
    accumulate<D, P>(dv, pa, dos + buf * P);
    to_parts<P>(pa, dp);
    accumulate<D, P>(dk, pa, qs + buf * P);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + g + 8 * hh;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const size_t at = base + (size_t)r * D + 8 * c + 2 * t;
      store_rope_inv(dk_out + at, dk[c][2 * hh], dk[c][2 * hh + 1], cosv, sinv,
                     (size_t)r * (D / 2) + 4 * c + t, 1.f);
      store_pair(dv_out + at, dv[c][2 * hh], dv[c][2 * hh + 1]);
    }
  }
}

// The pre-pass into scratch: planes of bh n D bf16, P per tensor, in the
// order rotated, scaled q; rotated k; with P > 1 v, then dout when given.
// Returns the planes' part stride through `lo`.
template <int D, typename T, int P>
cudaError_t prepass(const void* q, const void* k, const void* v, const void* dout,
                    const void* cosv, const void* sinv, float qmul, void* scratch, int bh, int n,
                    int64_t& lo, cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  lo = (int64_t)bh * n * D;
  bf16* qr = (bf16*)scratch;
  const int64_t pairs = lo / 2;
  const int blocks = (int)((pairs + 255) / 256 < 8192 ? (pairs + 255) / 256 : 8192);
  rotate_kernel<D, T, P><<<blocks, 256, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)cosv,
      (const float*)sinv, qr, qr + P * lo, qr + 2 * P * lo, qr + 3 * P * lo, lo, pairs, n, qmul);
  return cudaGetLastError();
}

// MODE kFull with `blocks` 0 is bt_flash_fwd's launch.
template <int D, typename T, int MODE>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* cosv,
                       const void* sinv, void* o, void* lse, int bh, int n, int heads,
                       bt::Dropout drop, float blocks, void* scratch, cudaStream_t stream) {
  constexpr int P = fwd_parts<T>();
  // bf16 kNoRope reads q, k and v in place
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  int64_t lo = 0;
  if constexpr (P > 1 || MODE != kNoRope) {
    const bool rot = MODE != kNoRope;
    const cudaError_t err = prepass<D, T, P>(
        q, k, P > 1 ? v : nullptr, nullptr, rot ? cosv : nullptr, rot ? sinv : nullptr,
        rot ? bt::qscale<D>() : 1.f, scratch, bh, n, lo, stream);
    if (err != cudaSuccess) return err;
    qp = (const bf16*)scratch;
    kp = qp + P * lo;
    if (P > 1) vp = kp + P * lo;
  }
  auto kernel = flash_fwd_kernel<D, T, MODE>;
  cudaError_t err = bt::allow_smem(kernel, fwd_smem<D, P>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, (n + kRows - 1) / kRows), kThreads, fwd_smem<D, P>(), stream>>>(
      qp, kp, vp, lo, (T*)o, (float*)lse, n, heads, drop, blocks);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* cosv,
                       const void* sinv, const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, int bh, int n, int heads, bt::Dropout drop,
                       void* scratch, cudaStream_t stream) {
  constexpr int P = bwd_parts<T>();
  int64_t lo = 0;
  cudaError_t err = prepass<D, T, P>(q, k, P > 1 ? v : nullptr, P > 1 ? dout : nullptr, cosv,
                                     sinv, bt::qscale<D>(), scratch, bh, n, lo, stream);
  if (err != cudaSuccess) return err;
  const bf16* qr = (const bf16*)scratch;
  const bf16* kr = qr + P * lo;
  // bf16 reads v and dout in place
  const bf16* vp = P > 1 ? kr + P * lo : (const bf16*)v;
  const bf16* dp = P > 1 ? vp + P * lo : (const bf16*)dout;
  const dim3 grid(bh, (n + kRows - 1) / kRows);
  auto kq = flash_dq_kernel<D, T>;
  if ((err = bt::allow_smem(kq, fwd_smem<D, P>())) != cudaSuccess) return err;
  kq<<<grid, kThreads, fwd_smem<D, P>(), stream>>>(
      qr, kr, vp, dp, lo, (const float*)cosv, (const float*)sinv, (const float*)lse,
      (const float*)delta, (T*)dq, n, heads, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto kkv = flash_dkv_kernel<D, T>;
  if ((err = bt::allow_smem(kkv, dkv_smem<D, P>())) != cudaSuccess) return err;
  kkv<<<grid, kThreads, dkv_smem<D, P>(), stream>>>(
      qr, kr, vp, dp, lo, (const float*)cosv, (const float*)sinv, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, n, heads, drop);
  return cudaGetLastError();
}

}  // namespace tc

template <int D, typename T>
cudaError_t dispatch_ablate(int mode, const void* q, const void* k, const void* v,
                            const void* cosv, const void* sinv, void* o, void* lout, int bh,
                            int n, float blocks, void* scratch, cudaStream_t s) {
  const bt::Dropout off{};
  switch (mode) {
    case kFull:
      return tc::launch_fwd<D, T, kFull>(q, k, v, cosv, sinv, o, lout, bh, n, 1, off, 0.f,
                                         scratch, s);
    case kNoRope:
      return tc::launch_fwd<D, T, kNoRope>(q, k, v, cosv, sinv, o, lout, bh, n, 1, off, blocks,
                                           scratch, s);
    case kNoExp:
      return tc::launch_fwd<D, T, kNoExp>(q, k, v, cosv, sinv, o, lout, bh, n, 1, off, blocks,
                                          scratch, s);
    case kMatmulOnly:
      return tc::launch_fwd<D, T, kMatmulOnly>(q, k, v, cosv, sinv, o, lout, bh, n, 1, off,
                                               blocks, scratch, s);
    default: return cudaErrorInvalidValue;
  }
}

// CALL(D, T) for the runtime head width and dtype code; another one is an
// invalid value (the wrapper raises before it gets here).
#define BT_FLASH_DISPATCH(CALL)                          \
  if (dtype == 0 && D == 16) return (int)CALL(16, float);        \
  if (dtype == 0 && D == 32) return (int)CALL(32, float);        \
  if (dtype == 1 && D == 16) return (int)CALL(16, __nv_bfloat16); \
  if (dtype == 1 && D == 32) return (int)CALL(32, __nv_bfloat16); \
  return (int)cudaErrorInvalidValue;

}  // namespace

// dtype: 0 float32, 1 bfloat16 for q, k, v and o (bh, n, D), D 16 or 32,
// each 16-byte aligned;
// cos/sin (n, D/2) float32, or both null for no rotation; lse (bh, n)
// float32, or null when it is not wanted. Dropout coordinates: item item0 +
// bh / heads, head bh % heads (row0 is unused); keep iff the Philox bits <
// thr, kept values times scale; on == 0 turns it off. scratch: the pre-pass's bfloat16 planes of
// bh n D elements: bfloat16 2 (the rotated q and k; v is read in place),
// float32 9 (q, k and v in three parts each).
extern "C" int bt_flash_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                            const void* cosv, const void* sinv, void* o, void* lse, int bh,
                            int n, int heads, unsigned seed, unsigned salt, unsigned thr,
                            float scale, int on, unsigned item0, unsigned row0, void* scratch,
                            void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on, item0, row0);
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(DD, TT) \
  tc::launch_fwd<DD, TT, kFull>(q, k, v, cosv, sinv, o, lse, bh, n, heads, d, 0.f, scratch, s)
  BT_FLASH_DISPATCH(BT_CALL)
#undef BT_CALL
}

// The forward's inputs, dout (bh, n, D) in the dtype, the forward's lse and
// delta = rowsum(dout * o) (bh, n) float32; results dq, dk, dv (bh, n, D) in
// the dtype; scratch: bfloat16 2 planes as for bt_flash_fwd (v and dout are
// read in place), float32 8 (q, k, v and dout in two parts each).
extern "C" int bt_flash_bwd(int dtype, int D, const void* q, const void* k, const void* v,
                            const void* cosv, const void* sinv, const void* dout,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            int bh, int n, int heads, unsigned seed, unsigned salt, unsigned thr,
                            float scale, int on, unsigned item0, unsigned row0, void* scratch,
                            void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on, item0, row0);
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(DD, TT)                                                                        \
  tc::launch_bwd<DD, TT>(q, k, v, cosv, sinv, dout, lse, delta, dq, dk, dv, bh, n, heads, d, \
                         scratch, s)
  BT_FLASH_DISPATCH(BT_CALL)
#undef BT_CALL
}

// The forward with parts left out (the modes of the kernel above): mode 0
// full (the launch of bt_flash_fwd without dropout), 1 no rotation and no
// scale, 2 no exp2 and no maximum (p = s, l = sum(s)), 3 products only
// (round(s) v over `blocks` key blocks, the denominator). lout (bh, n)
// float32 or null: the log-sum-exp (modes 0, 1, 3) or the denominator l
// (mode 2). scratch as for bt_flash_fwd (bfloat16 mode 1 reads none).
extern "C" int bt_flash_ablate(int dtype, int D, int mode, const void* q, const void* k,
                               const void* v, const void* cosv, const void* sinv, void* o,
                               void* lout, int bh, int n, float blocks, void* scratch,
                               void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(DD, TT) \
  dispatch_ablate<DD, TT>(mode, q, k, v, cosv, sinv, o, lout, bh, n, blocks, scratch, s)
  BT_FLASH_DISPATCH(BT_CALL)
#undef BT_CALL
}
