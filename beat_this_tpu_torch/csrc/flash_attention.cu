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
// with a (D, D) matrix product. Two designs here, one per dtype:
//
// float32 (SIMT FMAs; tensor-core products would be TF32, which misses the
// 1e-3 float32 limit):
//   flash_fwd: per (bh, 128 queries), one query per thread with its rotated,
//     scaled q row and its accumulator in registers, over 64-key tiles that
//     the block rotates and rounds into shared memory; n is any length
//     (bounds checks, keys past n score -inf).
//   flash_dq:  the same walk; p = exp2(s - lse), ds = round_T(p (dp keep -
//     delta)), dq = ds k, then the inverse rotation times D^-0.5.
//   flash_dkv: per (bh, 128 keys), one key per thread with its rotated k, v,
//     dk and dv in registers, over 64-query tiles staged in shared memory
//     (rotated, scaled and rounded as the forward's q, so that the scores
//     are the forward's and exp2(s - lse) sums to 1 over a query's keys; the
//     dk product takes the same rows and ends with the factor ln 2) with
//     their cotangent rows, lse, delta and mask bits.
//
// bfloat16 (namespace tc, tensor cores: mma.sync m16n8k16, bf16 operands,
// float32 accumulators, mma.cuh): the same functions with the same rounding
// points. A pre-pass writes rotated, scaled, rounded q and rotated, rounded k
// to bf16 scratch (bh, n, D) once, so no block rotates a tile again. A block
// is 4 warps; each warp owns 16 rows (queries; dkv: keys) whose operand
// fragments stay in registers, over 64-row tiles of the other side staged
// by cp.async through a 3-deep ring in shared memory and read by ldmatrix
// (the tile and its helpers live in attn_tc.cuh, shared with the time-axis
// training kernels of fused_time_train.cu).
//   flash_fwd: two walks over the keys. The first computes S = Q K^T and
//     each row's maximum m (quad shuffles); the second S again, p =
//     exp2(s - m), dropout bits (one Philox group of 4 keys spans two lanes:
//     the even lane draws row g's groups, the odd lane row g + 8's, and they
//     trade by one shuffle), round(p f) repacked from the C fragments into A
//     fragments, O += P V with V by ldmatrix.trans. p is thus rounded
//     relative to the row's true maximum, as in the plain version, and no
//     accumulator is ever rescaled.
//   flash_dq:  S = Q K^T and dP = dO V^T; dS = round(P (dP f - delta)); dQ +=
//     dS K; the inverse rotation times D^-0.5.
//   flash_dkv: S^T = K Q^T and dP^T = V dO^T over query tiles of the
//     forward's q; dV += round(P^T f) dO, dK += round(dS^T) Q; times ln 2 and
//     the inverse rotation. The mask bits of a 4-key group lie across rows
//     of S^T, so the block draws them into a shared bit table.
// dk and dv reduce over queries, so they get their key-major pass and no
// float atomics: two runs give the same bits. delta = rowsum(do * o) comes
// from the caller, as on the TPU.
//
// flash_fwd_kernel also carries the ablation modes of
// tools/bench_flash_ablate.py:make_kernel (bt_flash_ablate): the forward with
// parts left out, to see where its time goes. kNoRope takes q and k as they
// are (no rotation, no scale, no pre-pass); kNoExp sets p = s and l =
// sum(s), with no running maximum at all; kMatmulOnly adds round_T(s) v and
// divides by the number of key blocks the caller names. Each is a
// compile-time branch in both designs, so the full mode's code is the kernel
// the model runs.
//
// Bound on the H100: arithmetic (4 n^2 D multiply-adds per entry forward,
// 10 n^2 D backward, against O(n D) bytes); at D <= 32 the exp2 per score
// and the softmax's float32 work per score weigh as much as the products.
#include <type_traits>

#include "attn_rows.cuh"
#include "attn_tc.cuh"

namespace {

constexpr int kQT = 128;  // queries (dkv: keys) per block, one per thread
constexpr int kKT = 64;   // keys (dkv: queries) per staged tile
constexpr float kLn2 = 0.6931471805599453f;
// ablation modes of the forward (kFull is the kernel the model runs)
constexpr int kFull = 0, kNoRope = 1, kNoExp = 2, kMatmulOnly = 3;

// Stage rows [r0, r0 + kKT) of src into dst (zeros past n), by pairs;
// ROTATE: rotated, times `mul`, and rounded to T.
template <int D, typename T, bool ROTATE>
__device__ __forceinline__ void stage_rows(float (*dst)[D], const T* __restrict__ src,
                                           size_t base, int r0, int n,
                                           const float* __restrict__ cosv,
                                           const float* __restrict__ sinv, float mul = 1.f) {
  for (int e = threadIdx.x; e < kKT * (D / 2); e += kQT) {
    const int r = e / (D / 2), i = e % (D / 2), t = r0 + r;
    float a = 0.f, b = 0.f;
    if (t < n) {
      a = bt::to_f(src[base + (size_t)t * D + 2 * i]);
      b = bt::to_f(src[base + (size_t)t * D + 2 * i + 1]);
      if (ROTATE && cosv != nullptr) {
        const float cs = cosv[(size_t)t * (D / 2) + i], sn = sinv[(size_t)t * (D / 2) + i];
        const float ra = a * cs - b * sn, rb = b * cs + a * sn;
        a = ra;
        b = rb;
      }
      if (ROTATE) {
        a = bt::round_to<T>(a * mul);
        b = bt::round_to<T>(b * mul);
      }
    }
    dst[r][2 * i] = a;
    dst[r][2 * i + 1] = b;
  }
}

// MODE kNoExp writes its denominator l, not a log-sum-exp, to `lse`;
// `blocks` is kMatmulOnly's denominator.
template <int D, typename T, int MODE = kFull>
__global__ void __launch_bounds__(kQT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ cosv, const float* __restrict__ sinv,
                     T* __restrict__ o, float* __restrict__ lse, int n, int heads,
                     bt::Dropout drop, float blocks = 0.f) {
  __shared__ __align__(16) float ks[kKT][D];
  __shared__ __align__(16) float vs[kKT][D];
  const int bh = blockIdx.x, item = bh / heads, h = bh % heads;
  const int t = blockIdx.y * kQT + threadIdx.x;
  const size_t base = (size_t)bh * n * D;
  float qr[D], acc[D];
  bt::zero_row(qr);
  bt::zero_row(acc);
  if (t < n) {
    if constexpr (MODE == kNoRope)
      bt::load_row<D>(qr, q + base + (size_t)t * D);
    else
      bt::load_rotated<D, T>(qr, q + base + (size_t)t * D, cosv, sinv, t, bt::qscale<D>());
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < n; k0 += kKT) {
    stage_rows<D, T, MODE != kNoRope>(ks, k, base, k0, n, cosv, sinv);
    stage_rows<D, T, false>(vs, v, base, k0, n, cosv, sinv);
    __syncthreads();
    const int kn = min(kKT, n - k0);
    if constexpr (MODE == kNoExp || MODE == kMatmulOnly) {
      // no softmax: the scores themselves weigh v (keys past n staged as zeros)
      for (int j = 0; j < kn; ++j) {
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) a += qr[d] * ks[j][d];
        if constexpr (MODE == kNoExp) l += a;
        a = bt::round_to<T>(a);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] += a * vs[j][d];
      }
    } else {
      float s[kKT];
      float mt = m;
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) a += qr[d] * ks[j][d];
        s[j] = j < kn ? a : -INFINITY;
        mt = fmaxf(mt, s[j]);
      }
      const float corr = exp2f(m - mt);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int jg = 0; jg < kKT / 4; ++jg) {
        float f[4];
        bt::keep4(drop, bt::kSiteAttnProbs, item, h, t, (k0 >> 2) + jg, f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[4 * jg + e] - mt);
          l += p;
          const float a = bt::round_to<T>(p * f[e]);
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] += a * vs[4 * jg + e][d];
        }
      }
      m = mt;
    }
    __syncthreads();
  }
  if (t >= n) return;
  if constexpr (MODE == kMatmulOnly) l = blocks;
  if (lse != nullptr) lse[(size_t)bh * n + t] = MODE == kNoExp ? l : m + log2f(l);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] /= l;
  bt::store_row<D>(o + base + (size_t)t * D, acc);
}

template <int D, typename T>
__global__ void __launch_bounds__(kQT)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ cosv, const float* __restrict__ sinv,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq_out, int n, int heads,
                    bt::Dropout drop) {
  __shared__ __align__(16) float ks[kKT][D];
  __shared__ __align__(16) float vs[kKT][D];
  const int bh = blockIdx.x, item = bh / heads, h = bh % heads;
  const int t = blockIdx.y * kQT + threadIdx.x;
  const bool ok = t < n;
  const size_t base = (size_t)bh * n * D;
  float qr[D], dor[D], dq[D];
  bt::zero_row(qr);
  bt::zero_row(dor);
  bt::zero_row(dq);
  if (ok) {
    bt::load_rotated<D, T>(qr, q + base + (size_t)t * D, cosv, sinv, t, bt::qscale<D>());
    bt::load_row<D>(dor, dout + base + (size_t)t * D);
  }
  const float ls = ok ? lse[(size_t)bh * n + t] : 0.f;
  const float dl = ok ? delta[(size_t)bh * n + t] : 0.f;
  for (int k0 = 0; k0 < n; k0 += kKT) {
    stage_rows<D, T, true>(ks, k, base, k0, n, cosv, sinv);
    stage_rows<D, T, false>(vs, v, base, k0, n, cosv, sinv);
    __syncthreads();
    const int kn = min(kKT, n - k0);
    for (int jg = 0; jg < kKT / 4; ++jg) {
      float f[4];
      bt::keep4(drop, bt::kSiteAttnProbs, item, h, t, (k0 >> 2) + jg, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * jg + e;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s += qr[d] * ks[j][d];
          dp += dor[d] * vs[j][d];
        }
        const float p = j < kn ? exp2f(s - ls) : 0.f;
        const float ds = bt::round_to<T>(p * (dp * f[e] - dl));
#pragma unroll
        for (int d = 0; d < D; ++d) dq[d] += ds * ks[j][d];
      }
    }
    __syncthreads();
  }
  if (!ok) return;
  bt::rope_inv_scaled<D>(dq, cosv, sinv, t, bt::scale<D>());
  bt::store_row<D>(dq_out + base + (size_t)t * D, dq);
}

template <int D, typename T>
__global__ void __launch_bounds__(kQT)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ cosv, const float* __restrict__ sinv,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk_out,
                     T* __restrict__ dv_out, int n, int heads, bt::Dropout drop) {
  __shared__ __align__(16) float qs[kKT][D];   // rotated q times D^-0.5 log2(e), rounded
  __shared__ __align__(16) float dos[kKT][D];  // the cotangent rows
  __shared__ float lss[kKT], dls[kKT];
  __shared__ uint8_t keepb[kKT][kQT / 4];  // mask bits of 4 keys per byte
  const int bh = blockIdx.x, item = bh / heads, h = bh % heads, tl = threadIdx.x;
  const int kb0 = blockIdx.y * kQT, j = kb0 + tl;
  const bool ok = j < n;
  const size_t base = (size_t)bh * n * D;
  float kr[D], vr[D], dk[D], dv[D];
  bt::zero_row(kr);
  bt::zero_row(vr);
  bt::zero_row(dk);
  bt::zero_row(dv);
  if (ok) {
    bt::load_rotated<D, T>(kr, k + base + (size_t)j * D, cosv, sinv, j, 1.f);
    bt::load_row<D>(vr, v + base + (size_t)j * D);
  }
  for (int q0 = 0; q0 < n; q0 += kKT) {
    stage_rows<D, T, true>(qs, q, base, q0, n, cosv, sinv, bt::qscale<D>());
    stage_rows<D, T, false>(dos, dout, base, q0, n, cosv, sinv);
    for (int i = tl; i < kKT; i += kQT) {
      const bool in = q0 + i < n;
      lss[i] = in ? lse[(size_t)bh * n + q0 + i] : 0.f;
      dls[i] = in ? delta[(size_t)bh * n + q0 + i] : 0.f;
    }
    if (drop.on) {
      for (int g = tl; g < kKT * (kQT / 4); g += kQT) {
        const int i = g / (kQT / 4), kg = g % (kQT / 4);
        const uint4 b = bt::philox4x32_10(
            make_uint4((kb0 >> 2) + kg, q0 + i, item, (bt::kSiteAttnProbs << 16) | h), drop.seed,
            drop.salt);
        keepb[i][kg] = (uint8_t)((b.x < drop.thr) | ((b.y < drop.thr) << 1) |
                                 ((b.z < drop.thr) << 2) | ((b.w < drop.thr) << 3));
      }
    }
    __syncthreads();
    const int qn = min(kKT, n - q0);
    for (int i = 0; i < qn; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s += qs[i][d] * kr[d];
        dp += dos[i][d] * vr[d];
      }
      const float f = !drop.on ? 1.f : ((keepb[i][tl >> 2] >> (tl & 3)) & 1) ? drop.scale : 0.f;
      const float p = exp2f(s - lss[i]);
      const float a = bt::round_to<T>(p * f);
      const float ds = bt::round_to<T>(p * (dp * f - dls[i]));
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] += a * dos[i][d];
        dk[d] += ds * qs[i][d];
      }
    }
    __syncthreads();
  }
  if (!ok) return;
  bt::rope_inv_scaled<D>(dk, cosv, sinv, j, kLn2);
  bt::store_row<D>(dk_out + base + (size_t)j * D, dk);
  bt::store_row<D>(dv_out + base + (size_t)j * D, dv);
}

// -- bfloat16 on the tensor cores ---------------------------------------------

namespace tc {

// qr = round(rope(q) * qmul) and kr = round(rope(k)) over bh * n rows of D
// (row r at position r % n), one rotation pair per thread and step; null
// tables: no rotation.
template <int D>
__global__ void __launch_bounds__(256)
    rotate_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const float* __restrict__ cosv, const float* __restrict__ sinv,
                  bf16* __restrict__ qr, bf16* __restrict__ kr, int64_t pairs, int n, float qmul) {
  const uint32_t* q2 = reinterpret_cast<const uint32_t*>(q);
  const uint32_t* k2 = reinterpret_cast<const uint32_t*>(k);
  uint32_t* qr2 = reinterpret_cast<uint32_t*>(qr);
  uint32_t* kr2 = reinterpret_cast<uint32_t*>(kr);
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < pairs;
       e += (int64_t)gridDim.x * blockDim.x) {
    float cs = 1.f, sn = 0.f;
    if (cosv != nullptr) {
      const size_t at = (size_t)((e / (D / 2)) % n) * (D / 2) + e % (D / 2);
      cs = cosv[at];
      sn = sinv[at];
    }
    const float2 a = bt::unpack_bf16(q2[e]), b = bt::unpack_bf16(k2[e]);
    qr2[e] = bt::pack_bf16((a.x * cs - a.y * sn) * qmul, (a.y * cs + a.x * sn) * qmul);
    kr2[e] = bt::pack_bf16(b.x * cs - b.y * sn, b.y * cs + b.x * sn);
  }
}

// The forward over pre-rotated qr, kr (see MODE above); `blocks` is
// kMatmulOnly's denominator, `lse` gets kNoExp's denominator l. Two walks
// over the keys: the first takes each query's maximum score (QK^T alone),
// the second p = exp2(s - m) and O += P V, so that p is rounded to bf16
// relative to the row's maximum over all keys, as in the plain version (an
// online softmax would round it relative to a running maximum and rescale
// later). Tiles stream through kStages buffers: tile it + kStages - 1 is
// staged while tile it is used, and the one barrier per tile both
// publishes tile it and frees the buffer the next copy overwrites.
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ qr, const bf16* __restrict__ kr,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int n, int heads, bt::Dropout drop, float blocks) {
  constexpr bool kSoftmax = MODE == kFull || MODE == kNoRope;
  __shared__ __align__(16) Tile<D> ks[kStages];
  __shared__ __align__(16) Tile<D> vs[kStages];
  const int bh = blockIdx.x, item = bh / heads, h = bh % heads;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kRows + 16 * (threadIdx.x >> 5);
  const size_t base = (size_t)bh * n * D;
  const int tiles = (n + kTile - 1) / kTile;
  uint32_t qa[D / 16][4];
  load_a<D>(qa, qr + base, row0, n);
  float m[2] = {-INFINITY, -INFINITY};
  if constexpr (kSoftmax) {  // walk 1: the row maxima
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < tiles) stage<D>(ks[st], kr + base, st * kTile, n);
      bt::cp_async_commit();
    }
    for (int it = 0; it < tiles; ++it) {
      const int k0 = it * kTile;
      bt::cp_async_wait<kStages - 2>();
      __syncthreads();
      if (it + kStages - 1 < tiles)
        stage<D>(ks[(it + kStages - 1) % kStages], kr + base, k0 + (kStages - 1) * kTile, n);
      bt::cp_async_commit();
      float s[8][4];
      product_nt<D>(s, qa, ks[it % kStages]);
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
      stage<D>(ks[st], kr + base, st * kTile, n);
      stage<D>(vs[st], v + base, st * kTile, n);
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
      stage<D>(ks[nb], kr + base, k0 + (kStages - 1) * kTile, n);
      stage<D>(vs[nb], v + base, k0 + (kStages - 1) * kTile, n);
    }
    bt::cp_async_commit();
    float s[8][4];
    product_nt<D>(s, qa, ks[buf]);
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
    uint32_t pa[4][4];
    to_a(pa, s);
    product_nn<D>(acc, pa, vs[buf]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = MODE == kMatmulOnly ? blocks : quad_sum(l[hh]);
    const int r = row0 + g + 8 * hh;
    if (r >= n) continue;
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * n + r] = MODE == kNoExp ? l[hh] : m[hh] + log2f(l[hh]);
    uint32_t* dst = reinterpret_cast<uint32_t*>(o + base + (size_t)r * D);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      dst[4 * c + t] = bt::pack_bf16(acc[c][2 * hh] / l[hh], acc[c][2 * hh + 1] / l[hh]);
  }
}

// g (the rotation pair i = 4c + t of row r, channels 8c + 2t, +1) pulled
// back through the rotation at position r, times mul, stored rounded.
__device__ __forceinline__ uint32_t rope_inv_pair(float a, float b, const float* __restrict__ cosv,
                                                  const float* __restrict__ sinv, size_t at,
                                                  float mul) {
  const float cs = cosv == nullptr ? 1.f : cosv[at];
  const float sn = cosv == nullptr ? 0.f : sinv[at];
  return bt::pack_bf16((a * cs + b * sn) * mul, (b * cs - a * sn) * mul);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const bf16* __restrict__ qr, const bf16* __restrict__ kr,
                    const bf16* __restrict__ v, const float* __restrict__ cosv,
                    const float* __restrict__ sinv, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq_out, int n, int heads, bt::Dropout drop) {
  __shared__ __align__(16) Tile<D> ks[kStages];
  __shared__ __align__(16) Tile<D> vs[kStages];
  const int bh = blockIdx.x, item = bh / heads, h = bh % heads;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kRows + 16 * (threadIdx.x >> 5);
  const size_t base = (size_t)bh * n * D;
  const int tiles = (n + kTile - 1) / kTile;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) {
      stage<D>(ks[st], kr + base, st * kTile, n);
      stage<D>(vs[st], v + base, st * kTile, n);
    }
    bt::cp_async_commit();
  }
  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D>(qa, qr + base, row0, n);
  load_a<D>(da, dout + base, row0, n);
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
      stage<D>(ks[nb], kr + base, k0 + (kStages - 1) * kTile, n);
      stage<D>(vs[nb], v + base, k0 + (kStages - 1) * kTile, n);
    }
    bt::cp_async_commit();
    float s[8][4], dp[8][4];
    product_nt<D>(s, qa, ks[buf]);
    product_nt<D>(dp, da, vs[buf]);
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
          s[j][x] = p * (dp[j][x] * f - dl[hh]);  // dS, rounded by to_a
        }
    uint32_t pa[4][4];
    to_a(pa, s);
    product_nn<D>(acc, pa, ks[buf]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + g + 8 * hh;
    if (r >= n) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(dq_out + base + (size_t)r * D);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      dst[4 * c + t] = rope_inv_pair(acc[c][2 * hh], acc[c][2 * hh + 1], cosv, sinv,
                                     (size_t)r * (D / 2) + 4 * c + t, bt::scale<D>());
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const bf16* __restrict__ qr, const bf16* __restrict__ kr,
                     const bf16* __restrict__ v, const float* __restrict__ cosv,
                     const float* __restrict__ sinv, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk_out, bf16* __restrict__ dv_out, int n, int heads,
                     bt::Dropout drop) {
  __shared__ __align__(16) Tile<D> qs[kStages];   // the forward's rotated, scaled, rounded q
  __shared__ __align__(16) Tile<D> dos[kStages];  // the cotangent rows
  __shared__ float lss[kStages][kTile], dls[kStages][kTile];
  __shared__ uint8_t keepb[2][kTile][kRows / 4];  // mask bits of 4 keys per byte, by tile parity
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
    stage<D>(qs[b], qr + base, q0, n);
    stage<D>(dos[b], dout + base, q0, n);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      lss[b][i] = q0 + i < n ? lrow[q0 + i] : 0.f;
      dls[b][i] = q0 + i < n ? drow[q0 + i] : 0.f;
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) stage_tile(st);
    bt::cp_async_commit();
  }
  if (drop.on) keep_table(keepb[0], drop, item, h, kb0, 0);
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, kr + base, row0, n);
  load_a<D>(va, v + base, row0, n);
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
    product_nt<D>(s, ka, qs[buf]);    // S^T: the warp's 16 keys x 64 queries
    product_nt<D>(dp, va, dos[buf]);  // dP^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * j + 2 * t + e;
        const bool in = q0 + qi < n;
        const float lq = lss[buf][qi], dq = dls[buf][qi];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 2 * hh + e, kl = 16 * warp + g + 8 * hh;
          const float p = in ? fast_exp2(s[j][x] - lq) : 0.f;
          const float f = !drop.on                                          ? 1.f
                          : ((keepb[it & 1][qi][kl >> 2] >> (kl & 3)) & 1) ? drop.scale
                                                                            : 0.f;
          s[j][x] = p * f;                     // P^T f, rounded by to_a
          dp[j][x] = p * (dp[j][x] * f - dq);  // dS^T, rounded by to_a
        }
      }
    uint32_t pa[4][4];
    to_a(pa, s);
    product_nn<D>(dv, pa, dos[buf]);
    to_a(pa, dp);
    product_nn<D>(dk, pa, qs[buf]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + g + 8 * hh;
    if (r >= n) continue;
    uint32_t* dkr = reinterpret_cast<uint32_t*>(dk_out + base + (size_t)r * D);
    uint32_t* dvr = reinterpret_cast<uint32_t*>(dv_out + base + (size_t)r * D);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      dkr[4 * c + t] = rope_inv_pair(dk[c][2 * hh], dk[c][2 * hh + 1], cosv, sinv,
                                     (size_t)r * (D / 2) + 4 * c + t, kLn2);
      dvr[4 * c + t] = bt::pack_bf16(dv[c][2 * hh], dv[c][2 * hh + 1]);
    }
  }
}

// The pre-pass into scratch (2 bh n D bf16): rotated, scaled, rounded q,
// then rotated, rounded k.
template <int D>
cudaError_t rotate_qk(const void* q, const void* k, const void* cosv, const void* sinv,
                      bf16* scratch, int bh, int n, cudaStream_t stream) {
  const int64_t pairs = (int64_t)bh * n * (D / 2);
  const int blocks = (int)((pairs + 255) / 256 < 8192 ? (pairs + 255) / 256 : 8192);
  rotate_kernel<D><<<blocks, 256, 0, stream>>>(
      (const bf16*)q, (const bf16*)k, (const float*)cosv, (const float*)sinv, scratch,
      scratch + (size_t)bh * n * D, pairs, n, bt::qscale<D>());
  return cudaGetLastError();
}

template <int D, int MODE>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* cosv,
                       const void* sinv, void* o, void* lse, int bh, int n, int heads,
                       bt::Dropout drop, float blocks, void* scratch, cudaStream_t stream) {
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k;
  if constexpr (MODE != kNoRope) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const cudaError_t err = rotate_qk<D>(q, k, cosv, sinv, (bf16*)scratch, bh, n, stream);
    if (err != cudaSuccess) return err;
    qp = (const bf16*)scratch;
    kp = qp + (size_t)bh * n * D;
  }
  const dim3 grid(bh, (n + kRows - 1) / kRows);
  flash_fwd_kernel<D, MODE><<<grid, kThreads, 0, stream>>>(qp, kp, (const bf16*)v, (bf16*)o,
                                                           (float*)lse, n, heads, drop, blocks);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* cosv,
                       const void* sinv, const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, int bh, int n, int heads, bt::Dropout drop,
                       void* scratch, cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = rotate_qk<D>(q, k, cosv, sinv, (bf16*)scratch, bh, n, stream);
  if (err != cudaSuccess) return err;
  const bf16* qr = (const bf16*)scratch;
  const bf16* kr = qr + (size_t)bh * n * D;
  const dim3 grid(bh, (n + kRows - 1) / kRows);
  flash_dq_kernel<D><<<grid, kThreads, 0, stream>>>(
      qr, kr, (const bf16*)v, (const float*)cosv, (const float*)sinv, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, n, heads, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<D><<<grid, kThreads, 0, stream>>>(
      qr, kr, (const bf16*)v, (const float*)cosv, (const float*)sinv, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, n, heads, drop);
  return cudaGetLastError();
}

}  // namespace tc

// -- launches by dtype: float32 on the SIMT kernels above, bfloat16 on tc ------

template <int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* cosv,
                       const void* sinv, void* o, void* lse, int bh, int n, int heads,
                       bt::Dropout drop, void* scratch, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return tc::launch_fwd<D, kFull>(q, k, v, cosv, sinv, o, lse, bh, n, heads, drop, 0.f, scratch,
                                    stream);
  } else {
    const dim3 grid(bh, (n + kQT - 1) / kQT);
    flash_fwd_kernel<D, T><<<grid, kQT, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)cosv, (const float*)sinv, (T*)o,
        (float*)lse, n, heads, drop);
    return cudaGetLastError();
  }
}

template <int D, typename T, int MODE>
cudaError_t launch_ablate(const void* q, const void* k, const void* v, const void* cosv,
                          const void* sinv, void* o, void* lout, int bh, int n, float blocks,
                          void* scratch, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return tc::launch_fwd<D, MODE>(q, k, v, cosv, sinv, o, lout, bh, n, 1, bt::Dropout{}, blocks,
                                   scratch, stream);
  } else {
    const dim3 grid(bh, (n + kQT - 1) / kQT);
    flash_fwd_kernel<D, T, MODE><<<grid, kQT, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)cosv, (const float*)sinv, (T*)o,
        (float*)lout, n, 1, bt::Dropout{}, blocks);
    return cudaGetLastError();
  }
}

template <int D, typename T>
cudaError_t dispatch_ablate(int mode, const void* q, const void* k, const void* v,
                            const void* cosv, const void* sinv, void* o, void* lout, int bh,
                            int n, float blocks, void* scratch, cudaStream_t s) {
  switch (mode) {
    case kFull:
      return launch_fwd<D, T>(q, k, v, cosv, sinv, o, lout, bh, n, 1, bt::Dropout{}, scratch, s);
    case kNoRope:
      return launch_ablate<D, T, kNoRope>(q, k, v, cosv, sinv, o, lout, bh, n, blocks, scratch, s);
    case kNoExp:
      return launch_ablate<D, T, kNoExp>(q, k, v, cosv, sinv, o, lout, bh, n, blocks, scratch, s);
    case kMatmulOnly:
      return launch_ablate<D, T, kMatmulOnly>(q, k, v, cosv, sinv, o, lout, bh, n, blocks,
                                              scratch, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int D, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* cosv,
                       const void* sinv, const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, int bh, int n, int heads, bt::Dropout drop,
                       void* scratch, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return tc::launch_bwd<D>(q, k, v, cosv, sinv, dout, lse, delta, dq, dk, dv, bh, n, heads,
                             drop, scratch, stream);
  } else {
    const dim3 grid(bh, (n + kQT - 1) / kQT);
    flash_dq_kernel<D, T><<<grid, kQT, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)cosv, (const float*)sinv,
        (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, n, heads, drop);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_dkv_kernel<D, T><<<grid, kQT, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)cosv, (const float*)sinv,
        (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, n, heads, drop);
    return cudaGetLastError();
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
// float32, or null when it is not wanted. Dropout coordinates: item bh /
// heads, head bh % heads; keep iff the Philox bits < thr, kept values times
// scale; on == 0 turns it off. scratch: 2 bh n D bfloat16 for the rotated q
// and k (bfloat16 only; float32 takes null).
extern "C" int bt_flash_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                            const void* cosv, const void* sinv, void* o, void* lse, int bh,
                            int n, int heads, unsigned seed, unsigned salt, unsigned thr,
                            float scale, int on, void* scratch, void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(DD, TT) \
  launch_fwd<DD, TT>(q, k, v, cosv, sinv, o, lse, bh, n, heads, d, scratch, s)
  BT_FLASH_DISPATCH(BT_CALL)
#undef BT_CALL
}

// The forward's inputs, dout (bh, n, D) in the dtype, the forward's lse and
// delta = rowsum(dout * o) (bh, n) float32; results dq, dk, dv (bh, n, D) in
// the dtype; scratch as for bt_flash_fwd.
extern "C" int bt_flash_bwd(int dtype, int D, const void* q, const void* k, const void* v,
                            const void* cosv, const void* sinv, const void* dout,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            int bh, int n, int heads, unsigned seed, unsigned salt, unsigned thr,
                            float scale, int on, void* scratch, void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(DD, TT)                                                                    \
  launch_bwd<DD, TT>(q, k, v, cosv, sinv, dout, lse, delta, dq, dk, dv, bh, n, heads, d, \
                     scratch, s)
  BT_FLASH_DISPATCH(BT_CALL)
#undef BT_CALL
}

// The forward with parts left out (the modes of the kernel above): mode 0
// full (the launch of bt_flash_fwd without dropout), 1 no rotation and no
// scale, 2 no exp2 and no maximum (p = s, l = sum(s)), 3 products only
// (round(s) v over `blocks` key blocks, the denominator). lout (bh, n)
// float32 or null: the log-sum-exp (modes 0, 1, 3) or the denominator l
// (mode 2). scratch as for bt_flash_fwd.
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
