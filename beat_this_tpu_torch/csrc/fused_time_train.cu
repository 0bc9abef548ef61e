// The time-axis attention residual branch for training, forward and backward:
//   branch = drop_out(W_out (gate * drop_p(softmax(rope(q) rope(k)^T / sqrt(32))) v)),
// with q, k, v = W_qkv rmsnorm(x), gate = sigmoid(W_g rmsnorm(x) + b_g) per
// head, and the dropout masks drawn from Philox (philox.cuh) by element
// coordinates, so the backward regenerates the forward's masks.
//
// Replaces beat_this_tpu/ops/fused_time.py:_attn_train_kernel (forward, B4,
// reached through _fused_time_attn_train) and :_attn_train_bwd_kernel
// (backward, B5, through _fused_time_attn_train_bwd). The TPU kernels hold
// whole (n, n) score tiles per head and accumulate across a sequential
// (items, head_groups) grid. Here blocks run in parallel, so the branch is
// split into launches with O(n C) intermediates in device memory and never
// an (n, n) tensor. Every product runs on the tensor cores (mma.sync
// m16n8k16, bf16 operands, float32 accumulators): the attention core on the
// 4-warp tile of attn_tc.cuh (64 rows a block, 64-row tiles of the other
// side), the projections and weight gradients on the staged 128-row product
// of tc_product.cuh. float32 runs every product as three bf16 products of
// split operands (hi and lo parts, both bf16), about 16 significant bits,
// except the forward's q/k/v product (three parts, below).
//
// forward (B4), 5 launches; 2-4 are K2's too (the eval block, fused_time.cu)
//   1. operands: W_qkv^T and W_out^T as bf16 operands.
//   2. rows (time_qkv.cuh): g = round_T(rmsnorm(x) gamma) as an operand and
//      the gates from the float32 normed rows.
//   3. qkv (time_qkv.cuh): g W_qkv^T, RoPE in the epilogue; q, k, v saved as
//      T for the backward (float32: also as two-part operands). In float32
//      this product takes three-part operands (float32's own precision):
//      with two, the gate bias's gradient, a sum over rows that cancels,
//      moved 1.4e-4 from the plain version's at C 32 (the GPU test's limit is
//      1e-4; PERF.md, Findings, PR 10). The eval block keeps two.
//   4. attn_fwd (time_attn.cuh): the attention core; writes the normalized,
//      ungated o (float32), m, l and round_T(o * gate) as an operand.
//   5. attn_out: round_T(o * gate) W_out^T, then the output mask.
// backward (B5)
//   a. operands (float32 only): W_out, W_qkv, q, k, v split.
//   b. pre:   d_branch = round_T(dout * output mask) and round_T(o * gate)
//             as operands.
//   c. d_go = d_branch W_out, whose epilogue writes round_T(dO / l) (dO =
//      d_go gate) per (item, head) as an operand, the gate pullback d_z and
//      delta = rowsum(dO / l * o).
//   d. the core, one key-major pass: per (item * head, 64 keys) over the
//      query tiles, each score element's S, p, mask bits, dP and ds =
//      round_T(p (dp f - delta)) (dp = (dO / l) V^T) once; dv = round_T(p
//      f)^T dO / l and dk = ds^T Q (the unscaled q) in registers, and per
//      tile the block's share of dq, ds K over its 64 keys (ds^T staged in
//      shared memory, read transposed by ldmatrix), on the tensor cores.
//      The shares of a query tile are summed in float32 in a fixed order:
//      key block kb takes tiles kb, kb + 1, ... (cyclic), so the s-th
//      contribution to tile i is key block i - s's, one per tile a step.
//      A ticket per (item * head, query tile, warp) in global memory counts
//      the contributions made; a warp waits (acquire) until it reads its
//      own place, adds the running sum, stores it and raises the ticket
//      (release). The first stores without reading, the last adds, then
//      applies the inverse RoPE times 32^-0.5 and writes round_T(d_q) as an
//      operand. The running sums live in d_gn (step f writes it first), the
//      tickets and a start-order counter in d_gamma's partials (step g
//      writes them first), zeroed by step b: no new memory, and no float
//      atomics (blocks take their (item * head, key block) by an integer
//      counter, in start order, so a block waits only on blocks of its own
//      (item, head), all resident at once: a launch takes at most half the
//      blocks the card holds per (item, head), more key blocks take more
//      launches).
//   f. d_gn = [d_q | d_k | d_v] W_qkv (float32, scratch).
//   g. post:  per 32 rows, + d_z W_g and the RMSNorm backward for dx, the
//      per-tile partials of dgamma, dW_g and db_g, and g = round_T(rmsnorm(x)
//      gamma) as an operand.
//   h. dW_qkv = d_qkv^T g and dW_out = d_branch^T round_T(o * gate), over
//      groups of rows (one float32 partial per group), in one launch.
//   i. the partials summed in a fixed order, in one launch (two runs give
//      the same bits; no float atomics).
// The scratch layouts live only here (FwdLayout, BwdLayout); the wrapper
// asks bt_attn_train_fwd_scratch / bt_attn_train_bwd_scratch for the sizes.
//
// Bound on the H100: arithmetic. Attention costs 4 n^2 32 multiply-adds per
// (item, head) forward and about 2.5 times that backward, the projections
// 8 C^2 per row forward and twice that backward, against O(n C) bytes.
// bfloat16 values are rounded where the TPU kernel rounds (g, q/k/v, the
// dropped probabilities, the gated output, d_branch, dO / l, ds, and
// d_q/d_k/d_v before the weight products).
#include <algorithm>
#include <type_traits>

#include "time_attn.cuh"
#include "time_qkv.cuh"

namespace {

using mm::Operand;
using bf16 = __nv_bfloat16;

namespace tc {

// g (the rotation pair i = 4c + t of position r, channels 8c + 2t, +1)
// pulled back through the rotation, times 32^-0.5, stored as operand parts.
template <int P>
__device__ __forceinline__ void store_rope_inv(bf16* dst, int64_t lo, float a, float b,
                                               const float* __restrict__ cosv,
                                               const float* __restrict__ sinv, size_t at) {
  const float cs = cosv[at], sn = sinv[at];
  mm::store2<P>(dst, lo, (a * cs + b * sn) * kScale, (b * cs - a * sn) * kScale);
}

// The fused pass's smem: dkv_smem's Q and dO rings, m, delta and mask
// tables, then the block's K (P parts) and dS^T (P parts), and the block's
// place in start order.
template <int P> constexpr size_t fused_smem() {
  return dkv_smem<kHD, P>() + P * (sizeof(Tile<kHD>) + sizeof(Tile<kTile>)) + 16;
}

// The warp's dS^T (16 keys x 64 queries, A fragments of P parts) into the
// block's dS^T tiles (keys x queries), one 32-bit pair a store.
template <int P>
__device__ __forceinline__ void put_ds(Tile<kTile>* ds, const uint32_t (&pa)[P][4][4]) {
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5) + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<uint32_t*>(&ds[p][r0 + 8 * (r & 1)][16 * kk + 8 * (r >> 1) + 2 * t]) =
            pa[p][kk][r];
}

// A fragments of dS (the warp's 16 queries x the block's 64 keys) from the
// dS^T tiles, transposed by ldmatrix.
template <int P>
__device__ __forceinline__ void load_ds(uint32_t (&pa)[P][4][4], const Tile<kTile>* ds) {
  const int lane = threadIdx.x & 31, q0 = 16 * (threadIdx.x >> 5);
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      bt::ldsm_x4_t(pa[p][kk],
                    &ds[p][16 * kk + (lane & 7) + 8 * (lane >> 4)][q0 + 8 * ((lane >> 3) & 1)]);
}

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// One key-major pass over the score tiles of (item * head, 64 keys): dK, dV
// and the block's share of dQ. dol: round_T(dO / l) as (items * H, n, 32)
// operands (parts `lo` apart, as q, k, v); dqkv: (items, n, 3C) operand
// (parts dlo apart); dqacc: (items * H, n, 32) float32, dQ's running sums;
// sync: the start-order counter, then a ticket per (item * head, query
// tile, warp). The launch covers key blocks [kb_lo, kb_hi) of every (item,
// head), (item, head) outermost in start order.
template <int P>
__global__ void __launch_bounds__(kThreads)
    attn_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dol, int64_t lo,
                    const float* __restrict__ mrow, const float* __restrict__ delta,
                    const float* __restrict__ cosv, const float* __restrict__ sinv,
                    bf16* __restrict__ dqkv, int64_t dlo, float* dqacc,
                    uint32_t* sync, int n, int H, int kb_lo, int kb_hi,
                    bt::Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  Tile<kHD>* qs = reinterpret_cast<Tile<kHD>*>(smem_b);  // q, unscaled
  Tile<kHD>* dos = qs + kStages * P;                     // round_T(dO / l)
  Tile<kHD>* kst = dos + kStages * P;                    // the block's keys
  Tile<kTile>* dss = reinterpret_cast<Tile<kTile>*>(kst + P);  // dS^T, rounded parts
  float* lss = reinterpret_cast<float*>(dss + P);             // [kStages][kTile] m
  float* dls = lss + kStages * kTile;                         // [kStages][kTile] delta
  // mask bits of 4 keys per byte, by step parity
  auto* keepb = reinterpret_cast<uint8_t(*)[kTile][kRows / 4]>(dls + kStages * kTile);
  int* slot = reinterpret_cast<int*>(keepb + 2);
  const int T = (n + kTile - 1) / kTile, G = kb_hi - kb_lo;
  // blocks take their (item * head, key block) in the order they start, so
  // every block a block waits on of an earlier (item, head) has started
  if (threadIdx.x == 0) *slot = (int)(atomicAdd(sync, 1u) - gridDim.x / G * kb_lo);
  __syncthreads();
  const int id = *slot, bh = id / G, kb = kb_lo + id % G, item = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kb0 = kb * kRows, row0 = kb0 + 16 * warp;
  const size_t base = (size_t)bh * n * kHD;
  const float* mr = mrow + (size_t)bh * n;
  const float* dr = delta + (size_t)bh * n;
  // step s takes query tile kb + s (cyclic): each step, every tile gets one
  // block's contribution
  auto tile_of = [&](int s) { return kb + s < T ? kb + s : kb + s - T; };
  // stages step `st`'s query tile into buffer st % kStages
  auto stage_tile = [&](int st) {
    const int b = st % kStages, q0 = tile_of(st) * kTile;
    stage_parts<kHD, P>(qs + b * P, q + base, lo, q0, n);
    stage_parts<kHD, P>(dos + b * P, dol + base, lo, q0, n);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      lss[b * kTile + i] = q0 + i < n ? mr[q0 + i] : 0.f;
      dls[b * kTile + i] = q0 + i < n ? dr[q0 + i] : 0.f;
    }
  };
  stage_parts<kHD, P>(kst, k + base, lo, kb0, n);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < T) stage_tile(st);
    bt::cp_async_commit();
  }
  if (drop.on) keep_table(keepb[0], drop, item, h, kb0, tile_of(0) * kTile);
  uint32_t ka[P][kHD / 16][4], va[P][kHD / 16][4];
  load_parts<kHD, P>(ka, k + base, lo, row0, n);
  load_parts<kHD, P>(va, v + base, lo, row0, n);
  const bool kin[2] = {row0 + g < n, row0 + g + 8 < n};
  const int C = H * kHD;
  float dk[kHD / 8][4] = {}, dv[kHD / 8][4] = {};
  for (int s = 0; s < T; ++s) {
    const int qt = tile_of(s), q0 = qt * kTile, buf = s % kStages;
    bt::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < T) stage_tile(s + kStages - 1);
    bt::cp_async_commit();
    // the next step's bits into the table the previous step used
    if (drop.on && s + 1 < T) keep_table(keepb[(s + 1) & 1], drop, item, h, kb0, tile_of(s + 1) * kTile);
    float sc[8][4], dp[8][4];
    scores<kHD, P>(sc, ka, qs + buf * P);    // S^T: the warp's 16 keys x 64 queries
    scores<kHD, P>(dp, va, dos + buf * P);  // dP^T
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
          const float p = in && kin[hh] ? fast_exp2(sc[j][x] * kQScale - lq) : 0.f;
          const float f = !drop.on                                         ? 1.f
                          : ((keepb[s & 1][qi][kl >> 2] >> (kl & 3)) & 1) ? drop.scale
                                                                           : 0.f;
          sc[j][x] = p * f;                    // P^T f, rounded by to_parts
          dp[j][x] = p * (dp[j][x] * f - dq);  // dS^T, rounded by to_parts
        }
      }
    uint32_t pa[P][4][4];
    to_parts<P>(pa, sc);
    accumulate<kHD, P>(dv, pa, dos + buf * P);
    to_parts<P>(pa, dp);
    put_ds<P>(dss, pa);
    accumulate<kHD, P>(dk, pa, qs + buf * P);
    __syncthreads();
    // dQ of the warp's 16 queries over the block's 64 keys, dS K, added in
    // a fixed order to the sums of the blocks before
    const int qw = q0 + 16 * warp;
    if (qw >= n) continue;
    load_ds<P>(pa, dss);
    float dqp[kHD / 8][4] = {};
    accumulate<kHD, P>(dqp, pa, kst);
    // the blocks before this one at tile qt: kb + 1 .. kb + s (cyclic) where
    // they lie in the launch's key blocks, after every earlier launch's
    const int above = kb_hi - 1 - kb;
    const uint32_t rank = kb_lo + min(s, above) + max(0, s - above - (T - G));
    uint32_t* ticket = sync + 1 + ((size_t)bh * T + qt) * (kRows / 16) + warp;
    float* acc = dqacc + base + (size_t)qw * kHD;
    if (rank > 0) {
      if (lane == 0)
        while (load_acquire(ticket) != rank) {
        }
      __syncwarp();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (qw + g + 8 * hh >= n) continue;
#pragma unroll
        for (int c = 0; c < kHD / 8; ++c) {
          const float2 a = __ldcg(reinterpret_cast<const float2*>(acc + (g + 8 * hh) * kHD + 8 * c + 2 * t));
          dqp[c][2 * hh] += a.x;
          dqp[c][2 * hh + 1] += a.y;
        }
      }
    }
    if (rank + 1 < (uint32_t)T) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (qw + g + 8 * hh >= n) continue;
#pragma unroll
        for (int c = 0; c < kHD / 8; ++c)
          __stcg(reinterpret_cast<float2*>(acc + (g + 8 * hh) * kHD + 8 * c + 2 * t),
                 make_float2(dqp[c][2 * hh], dqp[c][2 * hh + 1]));
      }
      __syncwarp();  // the warp's stores before lane 0's release
      if (lane == 0) store_release(ticket, rank + 1);
      continue;
    }
    // the last contribution: the inverse RoPE times 32^-0.5, round_T(d_q)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = qw + g + 8 * hh;
      if (r >= n) continue;
      bf16* dst = dqkv + ((int64_t)item * n + r) * 3 * C + h * kHD;
#pragma unroll
      for (int c = 0; c < kHD / 8; ++c)
        store_rope_inv<P>(dst + 8 * c + 2 * t, dlo, dqp[c][2 * hh], dqp[c][2 * hh + 1], cosv,
                          sinv, (size_t)r * (kHD / 2) + 4 * c + t);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + g + 8 * hh;
    if (r >= n) continue;
    bf16* dst = dqkv + ((int64_t)item * n + r) * 3 * C + h * kHD;
#pragma unroll
    for (int c = 0; c < kHD / 8; ++c) {
      store_rope_inv<P>(dst + C + 8 * c + 2 * t, dlo, dk[c][2 * hh], dk[c][2 * hh + 1], cosv,
                        sinv, (size_t)r * (kHD / 2) + 4 * c + t);
      mm::store2<P>(dst + 2 * C + 8 * c + 2 * t, dlo, dv[c][2 * hh], dv[c][2 * hh + 1]);
    }
  }
}

// Blocks of the fused pass the card holds at once (cached per device, the
// first kDevices).
constexpr int kDevices = 16;

template <int P> cudaError_t resident_blocks(int* blocks) {
  static int kept[kDevices];
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && kept[dev]) {
    *blocks = kept[dev];
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_dkv_kernel<P>, kThreads,
                                                      fused_smem<P>());
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  if (dev < kDevices) kept[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace tc

// -- the row passes and the products ---------------------------------------------

using mm::kTM;

// round_T(o * gate) (items, n, C) and, in the backward, d_branch =
// round_T(dout * output mask) as operands (parts `lo` apart), four columns a
// thread and step; and the fused pass's nsync counters zeroed.
template <typename T>
__global__ void __launch_bounds__(bt::kThreads)
    attn_bwd_pre_kernel(const T* __restrict__ dout, const float* __restrict__ o,
                        const float* __restrict__ gates, bf16* __restrict__ dbr,
                        bf16* __restrict__ go, int64_t lo, int64_t rows, int C,
                        uint32_t* __restrict__ sync, int64_t nsync, bt::Dropout drop) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  const int H = C / kHD;
  const int64_t quads = rows * C / 4;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < nsync;
       e += (int64_t)gridDim.x * blockDim.x)
    sync[e] = 0;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < quads;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = e / (C / 4);
    const int c = 4 * (int)(e % (C / 4));
    float f[4];
    bt::row_keep4(drop, bt::kSiteAttnOut, (uint32_t)r, c >> 2, f);
    const float gate = gates[r * H + c / kHD];
    const int64_t at = r * C + c;
    float d[4], gv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[i] = bt::to_f(dout[at + i]) * f[i];
      gv[i] = o[at + i] * gate;
    }
    mm::store4<SPLIT ? 2 : 1>(dbr + at, lo, d);
    mm::store4<SPLIT ? 2 : 1>(go + at, lo, gv);
  }
}

// The forward's out projection: out = round_T(o * gate) W_out^T (A: the
// gated rows, B: W_out^T, both operands) times the output keep factors.
template <int BN, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    attn_out_kernel(Operand A, Operand B, T* __restrict__ out, int64_t rows, int C,
                    bt::Dropout drop) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int64_t m0 = (int64_t)blockIdx.y * kTM;
  const int n0 = blockIdx.x * BN;
  float acc[2][BN / 16][4];
  mm::product<false, BN, SPLIT ? 2 : 1>(acc, A, B, m0, n0, 0, C, rows, C,
                                reinterpret_cast<bf16*>(smem_b));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp & 3), wn = (BN / 2) * (warp >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int64_t row = m0 + wm + 16 * mi + (lane >> 2);
      const int col8 = n0 + wn + 8 * j, col = col8 + 2 * (lane & 3);
      float f[2][2];
      mm::row_keep(drop, bt::kSiteAttnOut, row, col8, f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t r = row + 8 * hh;
        if (r >= rows || col >= C) continue;
        out[r * C + col] = bt::from_f<T>(acc[mi][j][2 * hh] * f[hh][0]);
        out[r * C + col + 1] = bt::from_f<T>(acc[mi][j][2 * hh + 1] * f[hh][1]);
      }
    }
}

// d_go = d_branch W_out (A: d_branch, B: W_out, both operands), and from it
// per (row, head): round_T(dO / l) with dO = d_go gate into dol ((items *
// H, n, 32) operand, parts `lo` apart), d_z = zo gate (1 - gate) and delta
// = zo gate / l, zo = sum over the head's channels of d_go o. A warp's BN / 2
// columns are whole heads.
template <int BN, bool SPLIT>
__global__ void __launch_bounds__(bt::kThreads)
    attn_dgo_kernel(Operand A, Operand B, const float* __restrict__ o,
                    const float* __restrict__ gates, const float* __restrict__ lrow,
                    bf16* __restrict__ dol, int64_t lo, float* __restrict__ dz,
                    float* __restrict__ delta, int64_t rows, int n, int C) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int64_t m0 = (int64_t)blockIdx.y * kTM;
  const int n0 = blockIdx.x * BN;
  float acc[2][BN / 16][4];
  mm::product<false, BN, SPLIT ? 2 : 1>(acc, A, B, m0, n0, 0, C, rows, C,
                                reinterpret_cast<bf16*>(smem_b));
  const int H = C / kHD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wm = 32 * (warp & 3), wn = (BN / 2) * (warp >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t row = m0 + wm + 16 * mi + g + 8 * hh;
      const bool rok = row < rows;
      const int64_t item = rok ? row / n : 0;
      const int tt = rok ? (int)(row % n) : 0;
#pragma unroll
      for (int hw = 0; hw < BN / 64; ++hw) {
        const int c0 = n0 + wn + kHD * hw, head = c0 / kHD;
        const bool ok = rok && c0 < C;
        const float gate = ok ? gates[row * H + head] : 0.f;
        const size_t bht = ((size_t)item * H + head) * n + tt;
        const float l = ok ? lrow[bht] : 1.f;
        float zo = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * hw + jj, d = 8 * jj + 2 * t;
          const float a0 = acc[mi][j][2 * hh], a1 = acc[mi][j][2 * hh + 1];
          if (ok) {
            const float2 ov = *reinterpret_cast<const float2*>(o + row * C + c0 + d);
            zo += a0 * ov.x + a1 * ov.y;
            mm::store2<SPLIT ? 2 : 1>(dol + bht * kHD + d, lo, a0 * gate / l, a1 * gate / l);
          }
        }
        zo = tc::quad_sum(zo);
        if (ok && t == 0) {
          dz[row * H + head] = zo * gate * (1.f - gate);
          delta[bht] = zo * gate / l;
        }
      }
    }
}

// Products of the backward over the staged product's jobs (d_gn: one job;
// the weight gradients dW_qkv and dW_out: two).
template <bool AM, int BN, bool SPLIT>
__global__ void __launch_bounds__(bt::kThreads)
    attn_product_kernel(mm::ProductJob j0, mm::ProductJob j1) {
  mm::product_jobs<AM, BN, SPLIT ? 2 : 1>(j0, j1);
}

template <int C>
__host__ __device__ constexpr int post_smem_floats() {
  return 2 * bt::kRows * bt::tile_ld(C) + bt::kRows * (C / kHD) + bt::kRows;
}

// Per 32 rows: d_gn (float32, from the product) + d_z W_g, the RMSNorm
// backward for dx, the tile's partials of dgamma, dW_g and db_g, and g =
// round_T(rmsnorm(x) gamma) as an operand (parts glo apart).
template <int C, typename T>
__global__ void __launch_bounds__(bt::kThreads)
    attn_bwd_post_kernel(const T* __restrict__ x, const float* __restrict__ agamma,
                         const float* __restrict__ wg, const float* __restrict__ dgn,
                         const float* __restrict__ dz, T* __restrict__ dx, bf16* __restrict__ gop,
                         int64_t glo, float* __restrict__ dgp, float* __restrict__ dwgp,
                         float* __restrict__ dgbp, int64_t rows) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int H = C / kHD, ld = bt::tile_ld(C);
  extern __shared__ float smem[];
  float* t1 = smem;                 // x, then the float32 normed rows gn
  float* t2 = t1 + bt::kRows * ld;  // dgamma's products
  float* dzs = t2 + bt::kRows * ld;
  float* rn = dzs + bt::kRows * H;
  const int tid = threadIdx.x, cp = tid & 15, rg = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t row0 = (int64_t)blockIdx.x * bt::kRows;
  const int nrows = bt::tile_rows(rows, row0);
  const float sc = sqrtf((float)C);

  float acc[2][C / 16];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg + 16 * i;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      float2 v = make_float2(0.f, 0.f);
      if (r < nrows) v = *reinterpret_cast<const float2*>(dgn + (row0 + r) * C + 2 * cp + 32 * j);
      acc[i][2 * j] = v.x;
      acc[i][2 * j + 1] = v.y;
    }
  }
  for (int e = tid; e < bt::kRows * H; e += bt::kThreads) {
    const int r = e / H;
    dzs[e] = r < nrows ? dz[(row0 + r) * H + e % H] : 0.f;
  }
  bt::load_rows<C, T>(x, t1, row0, nrows);
  for (int r = warp; r < bt::kRows; r += bt::kThreads / 32) {
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) ss += t1[r * ld + c] * t1[r * ld + c];
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) rn[r] = fmaxf(sqrtf(ss), 1e-12f);
  }
  __syncthreads();

  // acc += d_z W_g; then dx = (w - n (n . w)) / r with w = d_gn gamma sqrt(C)
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg + 16 * i;
#pragma unroll
    for (int j = 0; j < C / 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * cp + 32 * j + e;
        float g = acc[i][2 * j + e];
        for (int h = 0; h < H; ++h) g += dzs[r * H + h] * wg[h * C + col];
        acc[i][2 * j + e] = g;
        const float n = t1[r * ld + col] / rn[r];
        s[i] += n * g * agamma[col] * sc;
        t2[r * ld + col] = g * n * sc;
      }
#pragma unroll
    for (int o = 8; o; o >>= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg + 16 * i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < C / 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * cp + 32 * j + e;
        const float n = t1[r * ld + col] / rn[r];
        const float w = acc[i][2 * j + e] * agamma[col] * sc;
        dx[(row0 + r) * C + col] = bt::from_f<T>((w - n * s[i]) / rn[r]);
      }
  }
  __syncthreads();
  for (int c = tid; c < C; c += bt::kThreads) {
    float sum = 0.f;
    for (int r = 0; r < bt::kRows; ++r) sum += t2[r * ld + c];
    dgp[blockIdx.x * (int64_t)C + c] = sum;
  }
  for (int e = tid; e < bt::kRows * C; e += bt::kThreads) {
    const int r = e / C, c = e % C;
    t1[r * ld + c] = t1[r * ld + c] / rn[r] * sc * agamma[c];
  }
  __syncthreads();
  for (int e = tid; e < bt::kRows * (C / 2); e += bt::kThreads) {
    const int r = e / (C / 2), c = 2 * (e % (C / 2));
    if (r < nrows)
      mm::store2<SPLIT ? 2 : 1>(gop + (row0 + r) * C + c, glo, t1[r * ld + c],
                                t1[r * ld + c + 1]);
  }
  for (int e = tid; e < H * C; e += bt::kThreads) {
    const int h = e / C, c = e % C;
    float sum = 0.f;
    for (int r = 0; r < bt::kRows; ++r) sum += dzs[r * H + h] * t1[r * ld + c];
    dwgp[blockIdx.x * (int64_t)H * C + e] = sum;
  }
  if (tid < H) {
    float sum = 0.f;
    for (int r = 0; r < bt::kRows; ++r) sum += dzs[r * H + tid];
    dgbp[blockIdx.x * H + tid] = sum;
  }
}

// The backward's four fixed-order sums (dgamma, dW_g, db_g, [dW_qkv;
// dW_out]), in one launch.
__global__ void __launch_bounds__(bt::kThreads) attn_bwd_sums_kernel(mm::SumJobs<4> s) {
  mm::column_sums(s);
}

// -- scratch layouts and launches ---------------------------------------------

// The forward's scratch (on a null base: its size alone), bf16 operands of
// Q = 3 parts in float32, 1 in bf16 (the q/k/v product's) W_qkv^T (Q 3C C),
// W_out^T (Q C C, of which the out projection reads P) and g (Q rows C); of
// P = 2 parts in float32, 1 in bf16 round_T(o * gate) (P rows C) and, in
// float32 only, q, k, v (P rows C each; bf16 q, k, v are their own
// operands).
struct FwdLayout {
  bf16 *wqkv, *wt, *g, *go, *qkv;
  size_t bytes;

  FwdLayout(void* base, bool split, int64_t rows, int C) {
    const int64_t Q = split ? 3 : 1, P = split ? 2 : 1, S = split ? 2 : 0;
    mm::Carver c(base);
    wqkv = c.take<bf16>(Q * 3 * C * C);
    wt = c.take<bf16>(Q * C * C);
    g = c.take<bf16>(Q * rows * C);
    go = c.take<bf16>(P * rows * C);
    qkv = c.take<bf16>(S * 3 * rows * C);
    bytes = c.bytes;
  }
};

// The backward's scratch, section by section: in float32 only, W_out,
// W_qkv, q, k, v split (2 parts); bf16 operands (P parts) d_branch,
// round_T(o * gate), round_T(dO / l), g (rows C each), d_q | d_k | d_v (rows
// 3C); float32 d_z, delta (rows H each), d_gn (rows C); the partials of
// dgamma (tiles C), dW_g (tiles H C), db_g (tiles H) per 32-row tile and of
// [dW_qkv; dW_out] (groups 4C C).
struct BwdLayout {
  bf16 *wout, *wqkv, *q, *k, *v, *dbr, *go, *dol, *g, *dqkv;
  float *dz, *delta, *dgn, *dgp, *dwgp, *dgbp, *dwp;
  size_t bytes;

  BwdLayout(void* base, bool split, int64_t rows, int C, int64_t groups) {
    const int64_t P = split ? 2 : 1, S = split ? 2 : 0, H = C / kHD;
    const int64_t tiles = (rows + bt::kRows - 1) / bt::kRows;
    mm::Carver c(base);
    wout = c.take<bf16>(S * C * C);
    wqkv = c.take<bf16>(S * 3 * C * C);
    q = c.take<bf16>(S * rows * C);
    k = c.take<bf16>(S * rows * C);
    v = c.take<bf16>(S * rows * C);
    dbr = c.take<bf16>(P * rows * C);
    go = c.take<bf16>(P * rows * C);
    dol = c.take<bf16>(P * rows * C);
    g = c.take<bf16>(P * rows * C);
    dqkv = c.take<bf16>(P * rows * 3 * C);
    dz = c.take<float>(rows * H);
    delta = c.take<float>(rows * H);
    dgn = c.take<float>(rows * C);
    dgp = c.take<float>(tiles * C);
    dwgp = c.take<float>(tiles * H * C);
    dgbp = c.take<float>(tiles * H);
    dwp = c.take<float>(groups * 4 * C * C);
    bytes = c.bytes;
  }
};

// Output tiles of the weight-gradient launch per row group: dW_qkv (3C, C)
// and dW_out (C, C) in blocks of kTM x product_n(C).
inline int wgrad_tiles(int C) {
  const int bn = mm::product_n(C);
  return (C + bn - 1) / bn * ((3 * C + kTM - 1) / kTM + (C + kTM - 1) / kTM);
}

template <int C, typename T>
cudaError_t launch_fwd(const void* x, const void* agamma, const void* wqkv, const void* wg,
                       const void* gb, const void* wout, const void* cosv, const void* sinv,
                       void* q, void* k, void* v, void* gates, void* o, void* mrow, void* lrow,
                       void* out, void* scratch, int64_t scratch_bytes, int items, int n,
                       bt::Dropout drop, cudaStream_t stream) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int H = C / kHD, P = mm::split_parts<T>(), Q = mm::full_parts<T>();
  constexpr int BN = mm::product_n(C);
  const int64_t rows = (int64_t)items * n, rlo = rows * C;
  const FwdLayout s(scratch, SPLIT, rows, C);
  if ((int64_t)s.bytes > scratch_bytes) return cudaErrorInvalidValue;

  // the first P of an operand's Q parts are its P-part split
  mm::ConvJobs conv;
  conv.add(wqkv, s.wqkv, 3 * C, C, 1);
  conv.add(wout, s.wt, C, C, 1);
  cudaError_t err = mm::convert<T, Q>(conv, stream);
  if (err != cudaSuccess) return err;

  // q, k, v saved as T for the backward; float32 also as two-part operands
  err = tq::qkv_launch<C, T, Q, P>((const T*)x, (const float*)agamma,
                                   Operand{s.wqkv, 3 * C, (int64_t)3 * C * C}, (const float*)wg,
                                   (const float*)gb, (const float*)cosv, (const float*)sinv, s.g,
                                   (float*)gates, (T*)q, (T*)k, (T*)v, SPLIT ? s.qkv : nullptr,
                                   rows, n, stream);
  if (err != cudaSuccess) return err;

  const bf16* qo = SPLIT ? s.qkv : (const bf16*)q;
  const bf16* ko = SPLIT ? s.qkv + P * rlo : (const bf16*)k;
  const bf16* vo = SPLIT ? s.qkv + 2 * P * rlo : (const bf16*)v;
  auto ka = tc::attn_fwd_kernel<P, false>;
  if ((err = bt::allow_smem(ka, tc::fwd_smem<kHD, P>())) != cudaSuccess) return err;
  ka<<<dim3(items * H, (n + tc::kRows - 1) / tc::kRows), tc::kThreads, tc::fwd_smem<kHD, P>(),
       stream>>>(qo, ko, vo, rlo, (const float*)gates, (float*)o, s.go, rlo, (float*)mrow,
                 (float*)lrow, n, H, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto kb = attn_out_kernel<BN, T>;
  const size_t smem_out = mm::product_smem<false, BN, P>();
  if ((err = bt::allow_smem(kb, smem_out)) != cudaSuccess) return err;
  kb<<<dim3((C + BN - 1) / BN, (unsigned)((rows + kTM - 1) / kTM)), bt::kThreads, smem_out,
       stream>>>(Operand{s.go, C, rlo}, Operand{s.wt, C, (int64_t)C * C}, (T*)out, rows, C,
                 drop);
  return cudaGetLastError();
}

template <int C, typename T>
cudaError_t launch_bwd(const void* x, const void* agamma, const void* wqkv, const void* wg,
                       const void* wout, const void* cosv, const void* sinv, const void* q,
                       const void* k, const void* v, const void* gates, const void* o,
                       const void* mrow, const void* lrow, const void* dout, void* dx,
                       void* dgamma, void* dw, void* dwg, void* dgb, void* scratch,
                       int64_t scratch_bytes, int items, int n, int64_t group_rows,
                       bt::Dropout drop, cudaStream_t stream) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int H = C / kHD, P = SPLIT ? 2 : 1, BN = mm::product_n(C);
  const int64_t rows = (int64_t)items * n, rlo = rows * C;
  const int64_t groups = mm::row_groups(rows, group_rows);
  const BwdLayout s(scratch, SPLIT, rows, C, groups);
  if ((int64_t)s.bytes > scratch_bytes) return cudaErrorInvalidValue;
  const int64_t tiles = (rows + bt::kRows - 1) / bt::kRows;
  const unsigned mtiles = (unsigned)((rows + kTM - 1) / kTM), ntiles = (C + BN - 1) / BN;
  cudaError_t err;

  // a. operands: the bf16 weights and q, k, v are their own operands
  if (SPLIT) {
    mm::ConvJobs conv;
    conv.add(wout, s.wout, C, C, 0);
    conv.add(wqkv, s.wqkv, 3 * C, C, 0);
    conv.add(q, s.q, rows, C, 0);
    conv.add(k, s.k, rows, C, 0);
    conv.add(v, s.v, rows, C, 0);
    if ((err = mm::convert<T, SPLIT ? 2 : 1>(conv, stream)) != cudaSuccess) return err;
  }
  const Operand wout_op{SPLIT ? s.wout : (const bf16*)wout, C, (int64_t)C * C};
  const Operand wqkv_op{SPLIT ? s.wqkv : (const bf16*)wqkv, C, (int64_t)3 * C * C};
  const bf16* qo = SPLIT ? s.q : (const bf16*)q;
  const bf16* ko = SPLIT ? s.k : (const bf16*)k;
  const bf16* vo = SPLIT ? s.v : (const bf16*)v;

  // b. d_branch and the gated rows as operands; the fused pass's counters
  // (the start order, then a ticket per (item * head, query tile, warp)) in
  // d_gamma's partials, which step g writes first
  const int qtiles = (n + tc::kTile - 1) / tc::kTile;
  const int64_t nsync = 1 + (qtiles > 1 ? (int64_t)items * H * qtiles * (tc::kRows / 16) : 0);
  if (nsync > tiles * C) return cudaErrorInvalidValue;
  uint32_t* sync = reinterpret_cast<uint32_t*>(s.dgp);
  const int64_t quads = rlo / 4;
  const unsigned pre_blocks =
      (unsigned)std::min<int64_t>((quads + bt::kThreads - 1) / bt::kThreads,
                                  mm::kCardSMs * 16);
  attn_bwd_pre_kernel<T><<<pre_blocks, bt::kThreads, 0, stream>>>(
      (const T*)dout, (const float*)o, (const float*)gates, s.dbr, s.go, rlo, rows, C, sync,
      nsync, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // c. d_go = d_branch W_out and its epilogue
  auto kc = attn_dgo_kernel<BN, SPLIT>;
  const size_t smem_nn = mm::product_smem<false, BN, SPLIT ? 2 : 1>();
  if ((err = bt::allow_smem(kc, smem_nn)) != cudaSuccess) return err;
  kc<<<dim3(ntiles, mtiles), bt::kThreads, smem_nn, stream>>>(
      Operand{s.dbr, C, rlo}, wout_op, (const float*)o, (const float*)gates, (const float*)lrow,
      s.dol, rlo, s.dz, s.delta, rows, n, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // d. the attention core, one key-major pass (dQ summed in d_gn, which
  // step f writes first). Every key block of an (item, head) must be
  // resident at once, so a launch takes at most half the blocks the card
  // holds per (item, head); longer sequences take several launches in turn.
  auto ke = tc::attn_dkv_kernel<P>;
  constexpr size_t smem_core = tc::fused_smem<P>();
  if ((err = bt::allow_smem(ke, smem_core)) != cudaSuccess) return err;
  int resident = 0;
  if ((err = tc::resident_blocks<P>(&resident)) != cudaSuccess) return err;
  const int per_launch = std::max(1, std::min(qtiles, resident / 2));
  for (int kb_lo = 0; kb_lo < qtiles; kb_lo += per_launch) {
    const int kb_hi = std::min(qtiles, kb_lo + per_launch);
    ke<<<(unsigned)((int64_t)items * H * (kb_hi - kb_lo)), tc::kThreads, smem_core, stream>>>(
        qo, ko, vo, s.dol, rlo, (const float*)mrow, s.delta, (const float*)cosv,
        (const float*)sinv, s.dqkv, 3 * rlo, s.dgn, sync, n, H, kb_lo, kb_hi, drop);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  // f. d_gn = d_qkv W_qkv
  const mm::ProductJob dgn{Operand{s.dqkv, 3 * C, 3 * rlo}, wqkv_op, s.dgn, C, 0, rows, C,
                           3 * C, 3 * C, mtiles};
  auto kf = attn_product_kernel<false, BN, SPLIT>;
  if ((err = bt::allow_smem(kf, smem_nn)) != cudaSuccess) return err;
  kf<<<dim3(ntiles, mtiles), bt::kThreads, smem_nn, stream>>>(dgn, dgn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // g. the row epilogue
  const size_t smem_post = sizeof(float) * post_smem_floats<C>();
  auto kg = attn_bwd_post_kernel<C, T>;
  if ((err = bt::allow_smem(kg, smem_post)) != cudaSuccess) return err;
  kg<<<(unsigned)tiles, bt::kThreads, smem_post, stream>>>(
      (const T*)x, (const float*)agamma, (const float*)wg, s.dgn, s.dz, (T*)dx, s.g, rlo, s.dgp,
      s.dwgp, s.dgbp, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // h. dW_qkv = d_qkv^T g and dW_out = d_branch^T round_T(o * gate)
  const int64_t wstep = (int64_t)4 * C * C;
  const mm::ProductJob wq{Operand{s.dqkv, 3 * C, 3 * rlo}, Operand{s.g, C, rlo}, s.dwp, C,
                          wstep, 3 * C, C, rows, group_rows,
                          (unsigned)((3 * C + kTM - 1) / kTM)};
  const mm::ProductJob wo{Operand{s.dbr, C, rlo}, Operand{s.go, C, rlo}, s.dwp + 3 * C * C, C,
                          wstep, C, C, rows, group_rows, (unsigned)((C + kTM - 1) / kTM)};
  auto kh = attn_product_kernel<true, BN, SPLIT>;
  const size_t smem_tn = mm::product_smem<true, BN, SPLIT ? 2 : 1>();
  if ((err = bt::allow_smem(kh, smem_tn)) != cudaSuccess) return err;
  kh<<<dim3(ntiles, wq.mtiles + wo.mtiles, (unsigned)groups), bt::kThreads, smem_tn, stream>>>(
      wq, wo);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // i. the fixed-order sums
  mm::SumJobs<4> sums{{s.dgp, s.dwgp, s.dgbp, s.dwp},
                      {(float*)dgamma, (float*)dwg, (float*)dgb, (float*)dw},
                      {(int)tiles, (int)tiles, (int)tiles, (int)groups},
                      {C, (int64_t)H * C, H, wstep},
                      {0}};
  attn_bwd_sums_kernel<<<sums.finish(), bt::kThreads, 0, stream>>>(sums);
  return cudaGetLastError();
}

#define BT_TIME_SWITCH(CALL)                 \
  switch (C) {                               \
    case 32: return CALL(32);                \
    case 64: return CALL(64);                \
    case 128: return CALL(128);              \
    case 256: return CALL(256);              \
    case 384: return CALL(384);              \
    case 512: return CALL(512);              \
    default: return cudaErrorInvalidValue;   \
  }

bool supported(int C) {
  return C == 32 || C == 64 || C == 128 || C == 256 || C == 384 || C == 512;
}

template <typename T>
cudaError_t dispatch_fwd(int C, const void* x, const void* agamma, const void* wqkv,
                         const void* wg, const void* gb, const void* wout, const void* cosv,
                         const void* sinv, void* q, void* k, void* v, void* gates, void* o,
                         void* mrow, void* lrow, void* out, void* scratch, int64_t scratch_bytes,
                         int items, int n, bt::Dropout drop, cudaStream_t s) {
#define BT_CALL(CC)                                                                          \
  launch_fwd<CC, T>(x, agamma, wqkv, wg, gb, wout, cosv, sinv, q, k, v, gates, o, mrow, lrow, \
                    out, scratch, scratch_bytes, items, n, drop, s)
  BT_TIME_SWITCH(BT_CALL)
#undef BT_CALL
}

template <typename T>
cudaError_t dispatch_bwd(int C, const void* x, const void* agamma, const void* wqkv,
                         const void* wg, const void* wout, const void* cosv, const void* sinv,
                         const void* q, const void* k, const void* v, const void* gates,
                         const void* o, const void* mrow, const void* lrow, const void* dout,
                         void* dx, void* dgamma, void* dw, void* dwg, void* dgb, void* scratch,
                         int64_t scratch_bytes, int items, int n, int64_t group_rows,
                         bt::Dropout drop, cudaStream_t s) {
#define BT_CALL(CC)                                                                         \
  launch_bwd<CC, T>(x, agamma, wqkv, wg, wout, cosv, sinv, q, k, v, gates, o, mrow, lrow,   \
                    dout, dx, dgamma, dw, dwg, dgb, scratch, scratch_bytes, items, n,        \
                    group_rows, drop, s)
  BT_TIME_SWITCH(BT_CALL)
#undef BT_CALL
}

}  // namespace

// Bytes of bt_attn_train_fwd's scratch over rows = items * n rows, in *bytes.
extern "C" int bt_attn_train_fwd_scratch(int dtype, int C, long long rows, long long* bytes) {
  if ((dtype != 0 && dtype != 1) || !supported(C) || rows < 0) return (int)cudaErrorInvalidValue;
  *bytes = (long long)FwdLayout(nullptr, dtype == 0, rows, C).bytes;
  return 0;
}

// dtype: 0 float32, 1 bfloat16 for x (items, n, C), wqkv (3C, C), wout (C, C),
// out (items, n, C) and the saved q, k, v (items, C/32, n, 32); agamma, wg
// (C/32, C), gb, cos/sin (n, 16), gates (items * n, C/32), o (items, n, C),
// mrow and lrow (items * C/32, n) are float32. scratch: scratch_bytes bytes,
// at least bt_attn_train_fwd_scratch's. Dropout: keep iff the Philox bits <
// thr, kept values times scale; on == 0 turns it off; the probabilities'
// items count from item0, the output's rows of (items n, C) from row0.
extern "C" int bt_attn_train_fwd(int dtype, int C, const void* x, const void* agamma,
                                 const void* wqkv, const void* wg, const void* gb,
                                 const void* wout, const void* cosv, const void* sinv, void* q,
                                 void* k, void* v, void* gates, void* o, void* mrow, void* lrow,
                                 void* out, void* scratch, long long scratch_bytes, int items,
                                 int n, unsigned seed, unsigned salt, unsigned thr, float scale,
                                 int on, unsigned item0, unsigned row0, void* stream) {
  if (items <= 0 || n <= 0) return 0;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on, item0, row0);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? dispatch_fwd<float>(C, x, agamma, wqkv, wg, gb, wout, cosv, sinv, q,
                                                k, v, gates, o, mrow, lrow, out, scratch,
                                                scratch_bytes, items, n, d, s)
               : dtype == 1
                   ? dispatch_fwd<__nv_bfloat16>(C, x, agamma, wqkv, wg, gb, wout, cosv, sinv, q,
                                                 k, v, gates, o, mrow, lrow, out, scratch,
                                                 scratch_bytes, items, n, d, s)
                   : cudaErrorInvalidValue);
}

// Output tiles of bt_attn_train_bwd's weight-gradient launch per row group.
extern "C" int bt_attn_wgrad_tiles(int C, int* tiles) {
  if (!supported(C)) return (int)cudaErrorInvalidValue;
  *tiles = wgrad_tiles(C);
  return 0;
}

// Bytes of bt_attn_train_bwd's scratch for these arguments, in *bytes.
extern "C" int bt_attn_train_bwd_scratch(int dtype, int C, long long rows, long long group_rows,
                                         long long* bytes) {
  if ((dtype != 0 && dtype != 1) || !supported(C) || rows < 0 || group_rows < 1)
    return (int)cudaErrorInvalidValue;
  *bytes = (long long)BwdLayout(nullptr, dtype == 0, rows, C, mm::row_groups(rows, group_rows))
               .bytes;
  return 0;
}

// The forward's inputs and saved tensors plus dout (items, n, C) in the
// dtype; results dx (items, n, C) in the dtype and float32 dgamma (C), dw
// (4C, C) = [dW_qkv; dW_out], dwg (C/32, C), dgb (C/32). scratch:
// scratch_bytes bytes, at least bt_attn_train_bwd_scratch's; the
// weight-gradient products take the rows in groups of group_rows >= 1
// (ops/fused_ff.py:ff_wgrad_split over bt_attn_wgrad_tiles).
extern "C" int bt_attn_train_bwd(int dtype, int C, const void* x, const void* agamma,
                                 const void* wqkv, const void* wg, const void* wout,
                                 const void* cosv, const void* sinv, const void* q, const void* k,
                                 const void* v, const void* gates, const void* o,
                                 const void* mrow, const void* lrow, const void* dout, void* dx,
                                 void* dgamma, void* dw, void* dwg, void* dgb, void* scratch,
                                 long long scratch_bytes, int items, int n, long long group_rows,
                                 unsigned seed, unsigned salt, unsigned thr, float scale, int on,
                                 unsigned item0, unsigned row0, void* stream) {
  if (items <= 0 || n <= 0) return 0;
  if (group_rows < 1) return (int)cudaErrorInvalidValue;
  const bt::Dropout d = bt::make_dropout(seed, salt, thr, scale, on, item0, row0);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? dispatch_bwd<float>(C, x, agamma, wqkv, wg, wout, cosv, sinv, q, k, v, gates,
                                         o, mrow, lrow, dout, dx, dgamma, dw, dwg, dgb, scratch,
                                         scratch_bytes, items, n, group_rows, d, s)
               : dtype == 1
                   ? dispatch_bwd<__nv_bfloat16>(C, x, agamma, wqkv, wg, wout, cosv, sinv, q, k,
                                                 v, gates, o, mrow, lrow, dout, dx, dgamma, dw,
                                                 dwg, dgb, scratch, scratch_bytes, items, n,
                                                 group_rows, d, s)
                   : cudaErrorInvalidValue);
}
