"""The design of the time-axis attention branch's training kernels (B4, B5,
`beat_this_tpu_torch/csrc/fused_time_train.cu`), checked on the CPU before
the card:

- float32 runs every product as three bf16 products of split operands
  (a_hi b_hi + a_hi b_lo + a_lo b_hi); the whole attention chain (S, exp2,
  O, dP, dS, dQ, dK, dV) then stays within the 1e-3 float32 limit of
  float64, and one bf16 product per step does not;
- the softmax scale multiplies the float32 product of the rounded q and k,
  as the plain version does (`ops/fused_time.py:fused_time_attention_train_ref`),
  and is not folded into a rounded q;
- the forward's two walks over the keys (the row maximum first) round p as
  the plain version does, where an online softmax rounds it against a
  running maximum;
- the backward's one key-major pass sums dQ from per-64-key-block float32
  shares in a fixed order (key block i - s gives tile i's s-th share), so
  the bits do not depend on the order blocks run in, and the sum stays
  within the float32 limit; its places (tickets) follow the steps at which
  the blocks reach a tile, over one launch or several;
- the wrapper's row groups of the weight-gradient launch and the scratch
  the backward's layout needs at the main and frontend shapes.

The plain version is held to the Pallas kernels in
tests/test_torch_train_kernels_ref.py, the kernels to the plain version in
tests/test_torch_cuda_kernels.py.

Tolerance: relative max deviation (over each quantity's largest entry) of
1e-3 for the split chain against float64, the float32 limit on the card.
"""

import math

import numpy as np
import pytest
import torch

from beat_this_tpu_torch.ops import fused_ff as ff_ops

SCALE = 32**-0.5
QSCALE = SCALE * math.log2(math.e)  # the kernels' base-2 softmax scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _mm(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a @ b in float32 as the kernels' products take it: three bf16
    products of split operands (two parts), or one bf16 product."""
    ah, bh = _bf16(a), _bf16(b)
    if parts == 1:
        return ah @ bh
    al, bl = _bf16(a - ah), _bf16(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _chain(q, k, v, dol, f, mm):
    """The attention chain of B4 / B5 for one (item, head): forward scores,
    probabilities and output, backward dP, dS, dQ, dK, dV; `mm` takes the
    products, the rest runs in the inputs' dtype."""
    s = mm(q, k.T) * QSCALE
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    o = mm(p * f, v) / l
    dp = mm(dol, v.T)
    delta = (dol * o).sum(-1, keepdim=True)
    ds = p * (dp * f - delta)
    return {"S": s, "p": p, "O": o, "dP": dp, "dS": ds, "dQ": mm(ds, k) * SCALE,
            "dK": mm(ds.T, q) * SCALE, "dV": mm((p * f).T, dol)}


@pytest.mark.parametrize("n,rate,seed", [(200, 0.0, 0), (256, 0.2, 1), (77, 0.2, 2)])
def test_split_products_meet_the_float32_limit(n, rate, seed):
    rng = np.random.default_rng(seed)
    # q, k, v as the projection of RMS-normed rows gives them: about unit entries
    q, k, v, dol = (torch.from_numpy(rng.standard_normal((n, 32))) for _ in range(4))
    dol = dol / n  # dO / l: the cotangent over the row sum
    keep = rng.random((n, n)) >= rate
    f = torch.from_numpy(np.where(keep, 1.0 / (1.0 - rate), 0.0))
    want = _chain(q, k, v, dol, f, lambda a, b: a @ b)
    f32 = [t.float() for t in (q, k, v, dol, f)]
    split = _chain(*f32, lambda a, b: _mm(a, b, 2))
    one = _chain(*f32, lambda a, b: _mm(a, b, 1))
    for name in want:
        assert _rel(split[name], want[name]) < 1e-3, (name, _rel(split[name], want[name]))
    # why float32 needs the split: one bf16 product per step misses the limit
    assert max(_rel(one[name], want[name]) for name in want) > 1e-3


def _rank(kb: int, s: int, tiles: int, kb_lo: int, kb_hi: int) -> int:
    """The fused pass's place of key block kb's share in query tile kb + s
    (cyclic) when a launch covers key blocks [kb_lo, kb_hi)
    (csrc/fused_time_train.cu: attn_dkv_kernel)."""
    above = kb_hi - 1 - kb
    return kb_lo + min(s, above) + max(0, s - above - (tiles - (kb_hi - kb_lo)))


def _fused_dq(ds: torch.Tensor, k: torch.Tensor, start: np.ndarray) -> torch.Tensor:
    """dQ as the fused pass sums it: the blocks, started in the order
    `start` (key blocks), each make a float32 split-product share of dS K
    over their 64 keys per query tile; a tile takes its shares in the order
    of their places, the first stored, the rest added; then the scale."""
    n, tile = ds.shape[0], 64
    tiles = -(-n // tile)
    shares = {}
    for kb in start:
        keys = slice(kb * tile, (kb + 1) * tile)
        for s in range(tiles):
            qt = (kb + s) % tiles
            rows = slice(qt * tile, (qt + 1) * tile)
            shares[qt, _rank(kb, s, tiles, 0, tiles)] = _mm(ds[rows, keys], k[keys], 2)
    out = torch.empty(n, k.shape[1], dtype=torch.float32)
    for qt in range(tiles):
        acc = shares[qt, 0]
        for r in range(1, tiles):
            acc = acc + shares[qt, r]
        out[qt * tile:(qt + 1) * tile] = acc
    return out * SCALE


@pytest.mark.parametrize("n,rate,seed", [(1500, 0.2, 5), (333, 0.1, 6), (64, 0.2, 7)])
def test_fused_pass_sums_dq_in_a_fixed_order(n, rate, seed):
    rng = np.random.default_rng(seed)
    q, k, v, dol = (torch.from_numpy(rng.standard_normal((n, 32))) for _ in range(4))
    dol = dol / n
    keep = rng.random((n, n)) >= rate
    f = torch.from_numpy(np.where(keep, 1.0 / (1.0 - rate), 0.0))
    want = _chain(q, k, v, dol, f, lambda a, b: a @ b)
    f32 = [t.float() for t in (q, k, v, dol, f)]
    split = _chain(*f32, lambda a, b: _mm(a, b, 2))
    tiles = -(-n // 64)
    first = _fused_dq(split["dS"], f32[1], np.arange(tiles))
    second = _fused_dq(split["dS"], f32[1], rng.permutation(tiles))
    assert torch.equal(first, second)
    assert _rel(first, want["dQ"]) < 1e-3, _rel(first, want["dQ"])


@pytest.mark.parametrize("tiles,per_launch", [(24, 24), (1, 1), (10, 4), (313, 132), (7, 3)])
def test_fused_pass_places_follow_the_steps(tiles, per_launch):
    """Per query tile, the places of the shares are 0 .. tiles - 1, each
    launch's after every earlier launch's, and within a launch a share's
    place follows the step at which its block reaches the tile: the share
    before it was made at an earlier step, so no block waits on a later
    one."""
    for qt in range(tiles):
        seen = []
        for kb_lo in range(0, tiles, per_launch):
            kb_hi = min(tiles, kb_lo + per_launch)
            steps = {(qt - kb) % tiles: _rank(kb, (qt - kb) % tiles, tiles, kb_lo, kb_hi)
                     for kb in range(kb_lo, kb_hi)}
            ranks = [steps[s] for s in sorted(steps)]
            assert ranks == list(range(kb_lo, kb_hi))
            seen += ranks
        assert seen == list(range(tiles))


def test_scale_on_the_accumulator_reproduces_the_plain_scores():
    """bf16: the plain version rounds q and k and scales their float32
    product (exp(s - max)); the kernels scale the float32 product by
    32^-0.5 log2(e) and take exp2. Folding the scale into a rounded q (as
    the flash kernels do for their own plain version) moves p by bf16's
    rounding of q."""
    rng = np.random.default_rng(3)
    q, k = (_bf16(torch.from_numpy(rng.standard_normal((300, 32)).astype(np.float32)) * 2)
            for _ in range(2))
    s = (q @ k.T) * SCALE  # ops/fused_time.py: fused_time_attention_train_ref
    plain = torch.exp(s - s.amax(-1, keepdim=True))
    s2 = (q @ k.T) * QSCALE
    kernel = torch.exp2(s2 - s2.amax(-1, keepdim=True))
    sf = _bf16(q * QSCALE) @ k.T
    folded = torch.exp2(sf - sf.amax(-1, keepdim=True))
    assert _rel(kernel, plain) < 1e-5
    assert _rel(folded, plain) > 1e-3


def _weights(s: torch.Tensor, tile: int, online: bool) -> torch.Tensor:
    """The bf16-rounded weights that enter P V for one row of base-2 scores,
    as each design leaves them after its walks over key tiles of `tile`:
    two walks round 2^(s - m) against the row's maximum m; an online
    softmax rounds against the running maximum of the tiles seen so far
    and rescales the accumulator when a later tile raises it."""
    if not online:
        return _bf16(torch.exp2(s - s.max()))
    w = torch.zeros_like(s)
    m = -math.inf
    for k0 in range(0, s.numel(), tile):
        mt = max(m, float(s[k0:k0 + tile].max()))
        w[:k0] *= 2.0 ** (m - mt) if m > -math.inf else 1.0
        w[k0:k0 + tile] = _bf16(torch.exp2(s[k0:k0 + tile] - mt))
        m = mt
    return w


def test_two_walks_round_p_as_the_plain_version():
    rng = np.random.default_rng(4)
    s = torch.from_numpy(rng.standard_normal(192).astype(np.float32))
    s[150] = 6.0  # the row's maximum first appears in the third 64-key tile
    plain = _bf16(torch.exp2(s - s.max()))  # round_T(p) against the final maximum
    assert torch.equal(_weights(s, 64, online=False), plain)
    online = _weights(s, 64, online=True)
    assert not torch.equal(online[:128], plain[:128])
    assert torch.equal(online[128:], plain[128:])


# output tiles per row group of B5's weight-gradient launch, dW_qkv (3C, C) and
# dW_out (C, C) in blocks of 128 rows x 64 (C <= 64) or 128 columns
# (csrc/fused_time_train.cu: bt_attn_wgrad_tiles)
WGRAD_TILES = {32: 2, 64: 3, 128: 4, 256: 16, 384: 36, 512: 64}


def test_wgrad_tiles_follow_the_product_blocks():
    for c, tiles in WGRAD_TILES.items():
        bn = 64 if c <= 64 else 128
        assert tiles == -(-c // bn) * (-(-3 * c // 128) + -(-c // 128))


def _bwd_scratch(rows: int, c: int, groups: int, split: bool) -> int:
    """Bytes of B5's scratch by its sections (csrc/fused_time_train.cu:
    BwdLayout), each rounded up to 256 bytes."""
    parts, h, tiles = 2 if split else 1, c // 32, -(-rows // 32)
    sections = [(2 * split * c * c, 2), (2 * split * 3 * c * c, 2)]
    sections += [(2 * split * rows * c, 2)] * 3  # q, k, v split (float32 only)
    sections += [(parts * rows * c, 2)] * 4 + [(parts * rows * 3 * c, 2)]
    sections += [(rows * h, 4)] * 2 + [(rows * c, 4)]
    sections += [(tiles * c, 4), (tiles * h * c, 4), (tiles * h, 4), (groups * 4 * c * c, 4)]
    return sum(-(-n * size // 256) * 256 for n, size in sections)


@pytest.mark.parametrize("rows,c,groups,gb_bf16,gb_f32", [
    (12000, 512, 5, 0.2, 0.4),     # a main layer: 8 crops x 1500 frames, 64 x 5 blocks
    (384000, 32, 132, 0.3, 0.6),   # frontend time block 0: 256 sequences, 2 x 132
    (192000, 64, 88, 0.3, 0.6),    # block 1: 128 sequences, 3 x 88
    (96000, 128, 66, 0.3, 0.6),    # block 2: 64 sequences, 4 x 66
])
def test_wgrad_groups_and_scratch_at_the_main_shapes(rows, c, groups, gb_bf16, gb_f32):
    tiles = WGRAD_TILES[c]
    group_rows = ff_ops.ff_wgrad_split(rows, tiles)
    assert -(-rows // group_rows) == groups
    # about two blocks per SM of the card
    assert 1.5 * ff_ops.CARD_SMS <= tiles * groups <= 2 * ff_ops.CARD_SMS + tiles
    assert _bwd_scratch(rows, c, groups, False) < gb_bf16 * 1e9
    assert _bwd_scratch(rows, c, groups, True) < gb_f32 * 1e9
