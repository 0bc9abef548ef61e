// Counter-based dropout for the training kernels: Philox4x32-10 keyed by
// (seed, salt), counter (col / 4, row, item, site << 16 | head). One call
// gives the bits of four neighbouring columns; an element is kept iff its
// bits are below `thr` (= ceil((1 - rate) * 2^32)) and then scaled by
// `scale` (= 1 / (1 - rate) in float32). beat_this_tpu_torch/ops/dropout.py
// computes the same bits in PyTorch, so a kernel and its plain version drop
// the same elements for the same seed.
//
// A call's items and rows count from its own first: `item0` and `row0` move
// them to the global batch, so a data-parallel shard draws the bits of its
// rows in the mask of the whole batch. A probability site adds item0 to its
// item (the batch-major word; its row is a query), a row site (item 0: the
// rows of a flattened activation) adds row0 to its row. At 0 they change
// nothing.
#pragma once

#include <stdint.h>

namespace bt {

// dropout sites (ops/dropout.py)
constexpr uint32_t kSiteAttnProbs = 0, kSiteAttnOut = 1, kSiteFFHidden = 2, kSiteFFOut = 3;

struct Dropout {
  uint32_t seed, salt, thr;
  float scale;
  int on;  // 0: rate 0, every factor is 1
  uint32_t item0, row0;  // the call's first item and first row in the global batch
};

// The C entry points' dropout arguments as a Dropout.
inline Dropout make_dropout(uint32_t seed, uint32_t salt, uint32_t thr, float scale, int on,
                            uint32_t item0, uint32_t row0) {
  Dropout d;
  d.seed = seed;
  d.salt = salt;
  d.thr = thr;
  d.scale = scale;
  d.on = on;
  d.item0 = item0;
  d.row0 = row0;
  return d;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Keep factors (0 or scale; all 1 when dropout is off) of the columns
// 4 * col4 .. 4 * col4 + 3 of the call's row `row` at a row site (item 0,
// head 0).
__device__ __forceinline__ void row_keep4(const Dropout& d, uint32_t site, uint32_t row,
                                          uint32_t col4, float (&f)[4]) {
  if (!d.on) {
    f[0] = f[1] = f[2] = f[3] = 1.f;
    return;
  }
  const uint4 b = philox4x32_10(make_uint4(col4, row + d.row0, 0u, site << 16), d.seed, d.salt);
  f[0] = b.x < d.thr ? d.scale : 0.f;
  f[1] = b.y < d.thr ? d.scale : 0.f;
  f[2] = b.z < d.thr ? d.scale : 0.f;
  f[3] = b.w < d.thr ? d.scale : 0.f;
}

}  // namespace bt
