// Per-thread rows of D = 16 or 32 head channels for the SIMT attention kernel
// on (entries, seq, D) tensors (small_attention.cu): 16-byte row loads and
// stores, and the rotation (RoPE, interleaved pairs, half-width float32
// tables of (seq, D / 2); null tables mean no rotation) with its inverse for
// the gradients. Also the softmax scales, which flash_attention.cu takes too.
#pragma once

#include "common.cuh"

namespace bt {

// D^-0.5 and D^-0.5 * log2(e), each rounded once to float32
template <int D> __host__ __device__ constexpr double scale_of() {
  static_assert(D == 16 || D == 32, "head widths 16 and 32 are instantiated");
  return D == 16 ? 0.25 : 0.17677669529663688;
}
template <int D> __host__ __device__ constexpr float scale() { return (float)scale_of<D>(); }
template <int D> __host__ __device__ constexpr float qscale() {
  return (float)(scale_of<D>() * 1.4426950408889634);
}

template <int D> __device__ __forceinline__ void zero_row(float (&x)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = 0.f;
}

// x = src[0..D) as float; src is 16-byte aligned.
template <int D> __device__ __forceinline__ void load_row(float (&x)[D], const float* src) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 v = p[i];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

template <int D>
__device__ __forceinline__ void load_row(float (&x)[D], const __nv_bfloat16* src) {
  const uint4* p = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const uint4 v = p[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[8 * i + 2 * e] = f.x;
      x[8 * i + 2 * e + 1] = f.y;
    }
  }
}

// dst[0..D) = x rounded to dst's type; dst is 16-byte aligned.
template <int D> __device__ __forceinline__ void store_row(float* dst, const float (&x)[D]) {
  float4* p = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < D / 4; ++i)
    p[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

template <int D>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float (&x)[D]) {
  uint4* p = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __floats2bfloat162_rn(x[8 * i + 2 * e], x[8 * i + 2 * e + 1]);
    p[i] = v;
  }
}

// x rotated by position t's angles.
template <int D>
__device__ __forceinline__ void rope(float (&x)[D], const float* __restrict__ cosv,
                                     const float* __restrict__ sinv, int t) {
  if (cosv == nullptr) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    const float cs = cosv[(size_t)t * (D / 2) + i], sn = sinv[(size_t)t * (D / 2) + i];
    const float a = x[2 * i], b = x[2 * i + 1];
    x[2 * i] = a * cs - b * sn;
    x[2 * i + 1] = b * cs + a * sn;
  }
}

// g pulled back through the rotation at position t (its transpose), times
// `mul`: the last step of dq and dk.
template <int D>
__device__ __forceinline__ void rope_inv_scaled(float (&g)[D], const float* __restrict__ cosv,
                                                const float* __restrict__ sinv, int t,
                                                float mul) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    const float cs = cosv == nullptr ? 1.f : cosv[(size_t)t * (D / 2) + i];
    const float sn = cosv == nullptr ? 0.f : sinv[(size_t)t * (D / 2) + i];
    const float a = g[2 * i], b = g[2 * i + 1];
    g[2 * i] = (a * cs + b * sn) * mul;
    g[2 * i + 1] = (b * cs - a * sn) * mul;
  }
}

// x = row `src` rotated at position t, times `mul`, rounded to T's precision.
template <int D, typename T>
__device__ __forceinline__ void load_rotated(float (&x)[D], const T* src,
                                             const float* __restrict__ cosv,
                                             const float* __restrict__ sinv, int t, float mul) {
  load_row<D>(x, src);
  rope<D>(x, cosv, sinv, t);
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = round_to<T>(x[d] * mul);
}

}  // namespace bt
