// The attention core of the frequency block's training backward (B7,
// fused_freq_train.cu), compiled apart in freq_core.cu: per (item, head),
// attention over the item's F <= 32 rows on the packed score tile of
// small_tile.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace fc {

// The forward recomputed over q | k | v (rows, 3C) of T, q and k rotated:
// writes o = round_T(round_T(p f) v / l) into o (rows, C) of T and go =
// round_T(o round_T(sig)) (sig: the gates, (rows, C / 32) float32) as an
// operand of P bf16 parts `lo` elements apart (tc_product.cuh).
template <typename T>
cudaError_t core_fwd(const T* qkv, const float* sig, T* o, __nv_bfloat16* go, int64_t lo,
                     int64_t rows, int C, int F, bt::Dropout drop, cudaStream_t stream);

// The backward from d_o (rows, C) of T: [d_q | d_k | d_v] (d_q and d_k
// pulled back through the rotation of the tables cosv, sinv (F, 16) and
// times 32^-0.5) into dqkv (rows, 3C) as an operand of P bf16 parts `dlo`
// elements apart.
template <typename T>
cudaError_t core_bwd(const T* qkv, const T* dO, const float* cosv, const float* sinv,
                     __nv_bfloat16* dqkv, int64_t dlo, int64_t rows, int C, int F,
                     bt::Dropout drop, cudaStream_t stream);

}  // namespace fc
