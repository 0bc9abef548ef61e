// Warp-level tensor-core building blocks for sm_90a: the bf16 m16n8k16
// product with float32 accumulators (`mma.sync`), `ldmatrix` fragment loads
// from shared memory, and `cp.async` 16-byte copies into shared memory.
//
// Fragments of one m16n8k16 product, lane = 4 g + t (g = lane / 4, t =
// lane % 4), two bf16 values per 32-bit register, the lower column (or
// row) in the lower half:
//   A (16 x 16, row-major): a[0] row g, cols 2t, 2t+1; a[1] row g + 8, the
//     same cols; a[2] row g, cols 2t + 8, 2t + 9; a[3] row g + 8, those;
//   B (16 x 8): b0 rows 2t, 2t+1 of col g; b1 rows 2t + 8, 2t + 9;
//   C (16 x 8, float32): c[0], c[1] row g, cols 2t, 2t+1; c[2], c[3] row
//     g + 8, the same cols.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bt {

// c += a b
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i .. 8i + 7 give the
// addresses of matrix i's rows (16 bytes each); r[i] is matrix i's fragment
// (lane 4g + t holds row g, elements 2t and 2t + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The same, each matrix transposed: lane 4g + t holds elements (2t, g) and
// (2t + 1, g) of the matrix as stored.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two floats rounded to bf16 (round to nearest even) in one register, `lo`
// in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

}  // namespace bt
