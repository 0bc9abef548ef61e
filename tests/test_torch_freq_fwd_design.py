"""The design of the frequency block's forward on the tensor cores, K3 (eval)
and B6 (training), one kernel (`beat_this_tpu_torch/csrc/fused_freq.cu`),
checked on the CPU before the card: the kernel emulated in torch as it
takes the block,

- the rows in 128-row tiles, the last one filled with zero rows;
- every product on bf16 operands with float32 sums, float32 values split
  into P bf16 parts (the products of parts i, j with i + j < P): two in K3,
  three in B6, one in bfloat16;
- g = round_T((x * sqrt(C) / |x|) * gamma) formed from the float32 rows, the
  gates from it and float32 W_g; q, k, v rounded after the product, q and k
  rotated by RoPE at position row % F and rounded again;
- the attention over packed 32 x 32 score tiles (32 / F items with a
  block-diagonal mask), p = exp2(s * 32^-0.5 log2(e) - m), l over the
  unrounded p, the probability keep factors from `ops/dropout.py` at
  (item, head, query, key) placed in the tile, round_T(p f) before P V, o =
  round_T(P V / l) and go = round_T(o gate);
- y1 = x + drop(go W_out^T) in float32, g2 from y1 as g from x, h =
  round_T(drop(gelu(g2 W1^T + b1))), out = round_T(y1 + drop(h W2^T + b2)),
  the row sites' masks at (row, column).

Tolerances: the emulation within the card's limits of the plain versions
(`fused_freq_roformer_train_ref`, and `fused_freq_roformer_ref` at eval):
1e-3 in float32, 2.5e-2 in bfloat16, at the three frequency shapes with
dropout off and on, over ragged row counts. Against float64, relative to
the largest entry: three parts within 1e-6 (float32's own error), two
within 1e-4 (the bar of tests/test_torch_ff_bwd_design.py), one part over
1e-3. The kernel is held to the plain versions on the card in
tests/test_torch_cuda_kernels.py, bit for bit on every mask.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from beat_this_tpu_torch.model.layers import Attention, FeedForward, rows_mask
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops import fused_freq as freq_ops
from beat_this_tpu_torch.ops.rotary import apply_rope, rope_tables

TILE, GROUP = 128, 32  # rows of a block's tile; rows of a packed score tile
QSCALE = 32**-0.5 * math.log2(math.e)
SEED = 13
SHAPES = [(32, 32, 5), (16, 64, 7), (8, 128, 37)]  # (F, C, items): 160, 112, 296 rows


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products by the dozen: threads add only their hand-off where
    several test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _parts(t: torch.Tensor, parts: int) -> list:
    out = []
    for _ in range(parts):
        out.append(_bf16(t))
        t = t - out[-1]
    return out


def _mm(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a @ b (batched) as the kernel's products take it: the bf16 products
    of parts i, j with i + j < parts, the small terms first."""
    ap, bp = _parts(a, parts), _parts(b, parts)
    out = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=a.dtype)
    for t in range(parts - 1, -1, -1):
        for i in range(t, -1, -1):
            out = out + ap[i] @ bp[t - i]
    return out


def _normed(rows: torch.Tensor, gamma: torch.Tensor, r) -> torch.Tensor:
    c = rows.shape[-1]
    rs = math.sqrt(c) / rows.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return r((rows * rs) * gamma)


def _emulated(x, attn: Attention, ff: FeedForward, cos, sin, parts: int, rate: float = 0.0,
              seed=None) -> torch.Tensor:
    """The kernel's forward on x (items, F, C) of dtype T (float32 or
    bfloat16) with operands of `parts` parts; dropout at `rate` from `seed`
    (off when None), all four sites under SALT_FREQ."""
    dtype = x.dtype
    items, f, c = x.shape
    heads, m = c // 32, ff.net[1].out_features
    r = _bf16 if dtype == torch.bfloat16 else (lambda t: t)
    on = rate > 0.0 and seed is not None
    rows = items * f
    padded = -(-rows // TILE) * TILE
    xs = torch.zeros(padded, c)
    xs[:rows] = x.float().reshape(rows, c)
    pos = torch.arange(padded) % f  # tiles start on item boundaries

    g = _normed(xs, attn.norm.gamma.float(), r)
    gates = r(torch.sigmoid(g @ attn.to_gates.weight.float().T + attn.to_gates.bias.float()))
    wqkv, wout = attn.to_qkv.weight.float(), attn.to_out[0].weight.float()
    idx = torch.arange(GROUP)
    same = idx[:, None] // f == idx[None, :] // f
    if on:  # the probabilities' keep factors at (item, head, query, key), packed
        keep = drop.keep_mask(seed, drop.SALT_FREQ, drop.SITE_ATTN_PROBS, padded // f, heads, f,
                              f, rate)
        packed = torch.zeros(padded // GROUP, heads, GROUP, GROUP)
        per = keep.reshape(padded // GROUP, GROUP // f, heads, f, f)
        for i in range(GROUP // f):
            packed[:, :, i * f:(i + 1) * f, i * f:(i + 1) * f] = per[:, i]
    branch = torch.zeros(padded, c)
    for h in range(heads):
        def head(which, rope):
            w = wqkv[which * c + 32 * h: which * c + 32 * (h + 1)]
            t = r(_mm(g, w.T, parts))
            if rope:
                t = r(apply_rope(t[None], cos[pos], sin[pos])[0])
            return t.reshape(-1, GROUP, 32)

        q, k, v = head(0, True), head(1, True), head(2, False)
        s = _mm(q, k.transpose(-1, -2), parts)
        s = torch.where(same, s, -torch.inf)
        mx = s.amax(-1, keepdim=True) * QSCALE
        p = torch.where(same, torch.exp2(s * QSCALE - mx), 0.0)
        l = p.sum(-1, keepdim=True)
        if on:
            p = p * packed[:, h]
        o = r(_mm(r(p), v, parts) / l).reshape(padded, 32)
        go = r(o * gates[:, h:h + 1])
        branch = branch + _mm(go, wout[:, 32 * h: 32 * (h + 1)].T, parts)
    if on:
        branch = branch * rows_mask(seed, drop.SALT_FREQ, drop.SITE_ATTN_OUT, branch, rate)
    y1 = xs + branch

    norm, lin1, _, _, lin2, _ = ff.net
    g2 = _normed(y1, norm.gamma.float(), r)
    hid = F.gelu(_mm(g2, lin1.weight.float().T, parts) + lin1.bias.float())
    if on:
        hid = hid * rows_mask(seed, drop.SALT_FREQ, drop.SITE_FF_HIDDEN, hid, rate)
    y = _mm(r(hid), lin2.weight.float().T, parts) + lin2.bias.float()
    if on:
        y = y * rows_mask(seed, drop.SALT_FREQ, drop.SITE_FF_OUT, y, rate)
    assert m == hid.shape[-1]
    return (y1 + y)[:rows].to(dtype).reshape(items, f, c)


def _block(c: int, seed: int):
    """An Attention and a FeedForward with numpy-seeded weights at the
    scales of the GPU tests."""
    rng = np.random.default_rng(seed)
    attn, ff = Attention(c, c // 32), FeedForward(c)
    with torch.no_grad():
        for p in list(attn.parameters()) + list(ff.parameters()):
            fan_in = p.shape[-1] if p.ndim == 2 else 1
            scale = 1 / np.sqrt(fan_in) if p.ndim == 2 else 0.1
            p.copy_(torch.from_numpy((scale * rng.standard_normal(p.shape)).astype(np.float32)))
        attn.norm.gamma.add_(1.0)
        ff.net[0].gamma.add_(1.0)
    return attn, ff


def _x(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("f,c,items", SHAPES)
def test_training_forward_holds_the_plain_version(f, c, items, rate):
    """B6 as emulated: three parts in float32, one in bfloat16."""
    attn, ff = _block(c, f + c)
    cos, sin = rope_tables(f, 32)
    x = _x((items, f, c), items)
    with torch.no_grad():
        for dtype, parts, limit in ((torch.float32, 3, 1e-3), (torch.bfloat16, 1, 2.5e-2)):
            xt = x.to(dtype)
            got = _emulated(xt, attn, ff, cos, sin, parts, rate, SEED)
            want = freq_ops.fused_freq_roformer_train_ref(xt, attn, ff, cos, sin, rate, SEED)
            assert got.dtype == dtype and got.shape == x.shape
            dev = _rel(got, want)
            assert dev <= limit if dtype == torch.float32 else dev < limit, (dtype, dev)


@pytest.mark.parametrize("f,c,items", SHAPES)
def test_eval_forward_holds_the_plain_version(f, c, items):
    """K3 as emulated: two parts in float32, one in bfloat16, no dropout."""
    attn, ff = _block(c, 2 * f + c)
    cos, sin = rope_tables(f, 32)
    x = _x((items, f, c), items + 1)
    with torch.no_grad():
        for dtype, parts, limit in ((torch.float32, 2, 1e-3), (torch.bfloat16, 1, 2.5e-2)):
            xt = x.to(dtype)
            got = _emulated(xt, attn, ff, cos, sin, parts)
            want = freq_ops.fused_freq_roformer_ref(xt, attn, ff, cos, sin)
            dev = _rel(got, want)
            assert dev <= limit if dtype == torch.float32 else dev < limit, (dtype, dev)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("f,c,items", [(16, 64, 11), (8, 128, 21)])
def test_float32_parts_against_float64(f, c, items, rate):
    """Three parts (B6) hold float32's own error of float64, two (K3) the
    split products' 1e-4, one bf16 part misses 1e-3."""
    attn, ff = _block(c, 3 * f + c)
    cos, sin = rope_tables(f, 32)
    x = _x((items, f, c), c + items)
    with torch.no_grad():
        want = freq_ops.fused_freq_roformer_train_ref(x.double(), attn.double(), ff.double(),
                                                      cos.double(), sin.double(), rate, SEED)
        attn, ff = attn.float(), ff.float()
        dev = {p: _rel(_emulated(x, attn, ff, cos, sin, p, rate, SEED), want) for p in (1, 2, 3)}
    assert dev[3] < 1e-6, dev
    assert dev[2] < 1e-4, dev
    assert dev[1] > 1e-3, dev


def test_packed_tiles_are_per_item_attention():
    """The block-diagonal 32 x 32 tiles give each item's own softmax: with
    F = 4, one item's rows changed change no other item's output."""
    f, c, items = 4, 32, 40
    attn, ff = _block(c, 7)
    cos, sin = rope_tables(f, 32)
    x = _x((items, f, c), 8)
    y = x.clone()
    y[9] += 1.0  # an item inside a 32-row group, beside 7 others
    with torch.no_grad():
        a = _emulated(x, attn, ff, cos, sin, 3, 0.1, SEED)
        b = _emulated(y, attn, ff, cos, sin, 3, 0.1, SEED)
    changed = (a != b).flatten(1).any(1)
    assert changed.tolist() == [i == 9 for i in range(items)]
