// Softmax attention over (bh, n, D) with the rotation of q and k inside,
// forward and backward:
//   o = drop_p(softmax(rope(q) rope(k)^T D^-0.5)) v     per leading entry,
// with an online softmax in base 2 (the factor D^-0.5 log2(e) is folded into
// q before q is rounded to the input type), dropout on the probabilities
// drawn from Philox (philox.cuh) by the coordinates (bh / heads, bh % heads,
// query, key), the normalizer summed over the undropped p, and optionally
// the base-2 log-sum-exp lse = m + log2(l) per query for the backward.
//
// Replaces beat_this_tpu/ops/flash_attention.py:_flash_kernel and
// :_flash_kernel_lse (forward, shared body _flash_fwd_body) and
// :_flash_dq_kernel / :_flash_dkv_kernel (backward). The TPU kernels pad n
// to multiples of 128, hold whole (block_q, block_k) score tiles and rotate
// with a (D, D) matrix product. Here:
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
//     their cotangent rows, lse, delta and mask bits. dk and dv reduce over
//     queries, so they get this key-major pass and no float atomics: two runs
//     give the same bits.
// delta = rowsum(do * o) comes from the caller, as on the TPU.
//
// flash_fwd_kernel also carries the ablation modes of
// tools/bench_flash_ablate.py:make_kernel (bt_flash_ablate): the forward with
// parts left out, to see where its time goes. kNoRope takes q and k as they
// are (no rotation, no scale); kNoExp sets p = s and l = sum(s), with no
// running maximum at all; kMatmulOnly adds round_T(s) v and divides by the
// number of key blocks the caller names. Each is a compile-time branch, so
// the full mode's code is the kernel the model runs.
//
// Bound on the H100: arithmetic (4 n^2 D multiply-adds per entry forward,
// 10 n^2 D backward, against O(n D) bytes). Products are float32 FMAs on the
// SIMT cores; bfloat16 values are widened on load and rounded where the TPU
// kernels round (q and k after the rotation, the dropped p, ds, o, dq, dk,
// dv).
#include "attn_rows.cuh"

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

template <int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* cosv,
                       const void* sinv, void* o, void* lse, int bh, int n, int heads,
                       bt::Dropout drop, cudaStream_t stream) {
  const dim3 grid(bh, (n + kQT - 1) / kQT);
  flash_fwd_kernel<D, T><<<grid, kQT, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)cosv, (const float*)sinv, (T*)o,
      (float*)lse, n, heads, drop);
  return cudaGetLastError();
}

template <int D, typename T, int MODE>
cudaError_t launch_ablate(const void* q, const void* k, const void* v, const void* cosv,
                          const void* sinv, void* o, void* lout, int bh, int n, float blocks,
                          cudaStream_t stream) {
  const dim3 grid(bh, (n + kQT - 1) / kQT);
  flash_fwd_kernel<D, T, MODE><<<grid, kQT, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)cosv, (const float*)sinv, (T*)o,
      (float*)lout, n, 1, bt::Dropout{}, blocks);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t dispatch_ablate(int mode, const void* q, const void* k, const void* v,
                            const void* cosv, const void* sinv, void* o, void* lout, int bh,
                            int n, float blocks, cudaStream_t s) {
  switch (mode) {
    case kFull: return launch_fwd<D, T>(q, k, v, cosv, sinv, o, lout, bh, n, 1, bt::Dropout{}, s);
    case kNoRope:
      return launch_ablate<D, T, kNoRope>(q, k, v, cosv, sinv, o, lout, bh, n, blocks, s);
    case kNoExp:
      return launch_ablate<D, T, kNoExp>(q, k, v, cosv, sinv, o, lout, bh, n, blocks, s);
    case kMatmulOnly:
      return launch_ablate<D, T, kMatmulOnly>(q, k, v, cosv, sinv, o, lout, bh, n, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int D, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* cosv,
                       const void* sinv, const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, int bh, int n, int heads, bt::Dropout drop,
                       cudaStream_t stream) {
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
// scale; on == 0 turns it off.
extern "C" int bt_flash_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                            const void* cosv, const void* sinv, void* o, void* lse, int bh,
                            int n, int heads, unsigned seed, unsigned salt, unsigned thr,
                            float scale, int on, void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(DD, TT) launch_fwd<DD, TT>(q, k, v, cosv, sinv, o, lse, bh, n, heads, d, s)
  BT_FLASH_DISPATCH(BT_CALL)
#undef BT_CALL
}

// The forward's inputs, dout (bh, n, D) in the dtype, the forward's lse and
// delta = rowsum(dout * o) (bh, n) float32; results dq, dk, dv (bh, n, D) in
// the dtype.
extern "C" int bt_flash_bwd(int dtype, int D, const void* q, const void* k, const void* v,
                            const void* cosv, const void* sinv, const void* dout,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            int bh, int n, int heads, unsigned seed, unsigned salt, unsigned thr,
                            float scale, int on, void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on);
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(DD, TT) \
  launch_bwd<DD, TT>(q, k, v, cosv, sinv, dout, lse, delta, dq, dk, dv, bh, n, heads, d, s)
  BT_FLASH_DISPATCH(BT_CALL)
#undef BT_CALL
}

// The forward with parts left out (the modes of the kernel above): mode 0
// full (the launch of bt_flash_fwd without dropout), 1 no rotation and no
// scale, 2 no exp2 and no maximum (p = s, l = sum(s)), 3 products only
// (round(s) v over `blocks` key blocks, the denominator). lout (bh, n)
// float32 or null: the log-sum-exp (modes 0, 1, 3) or the denominator l
// (mode 2).
extern "C" int bt_flash_ablate(int dtype, int D, int mode, const void* q, const void* k,
                               const void* v, const void* cosv, const void* sinv, void* o,
                               void* lout, int bh, int n, float blocks, void* stream) {
  if (bh <= 0 || n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define BT_CALL(DD, TT) \
  dispatch_ablate<DD, TT>(mode, q, k, v, cosv, sinv, o, lout, bh, n, blocks, s)
  BT_FLASH_DISPATCH(BT_CALL)
#undef BT_CALL
}
