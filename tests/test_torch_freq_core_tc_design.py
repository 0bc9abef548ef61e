"""The design of the attention core of the frequency block's training
backward on the tensor cores (B7's `freq_core_fwd_kernel` and
`freq_core_bwd_kernel`, `beat_this_tpu_torch/csrc/freq_core.cu`), checked on
the CPU before the card. The core's dataflow is emulated in torch per (item,
head) (the packed score tile of `csrc/small_tile.cuh` adds only zeros off
each item): float32 operands split into P bf16 parts (the products of parts
i, j with i + j < P, the small terms first), every other step in float32,
bfloat16 rounded where the kernels round:

  forward   S = Q K^T (parts) times 32^-0.5 log2(e), p = exp2(S - max), l
            the sum of the undropped p, A = round(p f), o = round(A V / l);
  backward  the cotangent of o rounded (d_o leaves B7's d_og launch in the
            compute dtype), S, p and Y = A V recomputed, dY = round(d_o /
            l), dA = dY V^T, delta = (d_o . Y) / l^2 (the cotangent of l
            negated), ds = round(p (f dA - delta)) (the natural-log scores'
            gradient, as the plain version's autograd rounds it), dq = ds K
            and dk = ds^T Q times 32^-0.5, dv = A^T dY.

The emulated core stands in for the plain core of a copy of
`ops/fused_freq.py:freq_attention_branch` (the copy with the plain core is
the plain version to the bit), inside the whole training block:

- with `freq_core.cu`'s parts (float32 three) the output, dx and the ten
  parameter gradients stay within the GPU test's float32 limit
  (`tests/test_torch_cuda_kernels.py:TRAIN_DTYPES`, 1e-4) of float64 and of
  the float32 plain version, at C 32 / 64 / 128, F 32 / 16 / 8 / 1, rates 0
  and 0.1; with two parts the gate bias's gradient, a sum over rows that
  cancels, drifts several times further from float64 than with three;
- in bfloat16 the emulation stays within `chip_smoke.py`'s 2.5e-2 of the
  plain version, and its ds, rounded in natural-log units, has the plain
  version's bits where B12's base-2 form (round(ln2 ds) / ln2) would not;
  delta from dY (sum A dA / l, as the SIMT core took it) would move a
  quarter of them.

Tolerance: relative max deviation over each quantity's largest entry.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from beat_this_tpu_torch.model.layers import (
    HEAD_DIM,
    Attention,
    FeedForward,
    rms_norm,
    round_grad,
    round_value,
    rows_mask,
)
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops import fused_ff as ff_ops
from beat_this_tpu_torch.ops import fused_freq as freq_ops
from beat_this_tpu_torch.ops.rotary import apply_rope, rope_tables

CORE_PARTS = 3  # freq_core.cu: kParts<float> = mm::full_parts
F32_LIMIT, BF16_LIMIT = 1e-4, 2.5e-2
SCALE = HEAD_DIM**-0.5
QSCALE = float(np.float32(SCALE * np.log2(np.e)))
LN2 = float(np.log(2.0))
SEED = 13


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """round_T, kept in the dtype of x (float32 and float64 stay)."""
    return x.to(dtype).to(x.dtype) if dtype == torch.bfloat16 else x


def _parts(x: torch.Tensor, parts: int) -> list:
    out = []
    for _ in range(parts):
        out.append(x.to(torch.bfloat16).to(x.dtype))
        x = x - out[-1]
    return out


def _mm(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """Batched a @ b as the kernels take it (mm::mma_parts): the products of
    parts i, j with i + j < parts, the small terms first, into fresh
    accumulators; plain when parts is 0."""
    if parts == 0:
        return a @ b
    pa, pb = _parts(a, parts), _parts(b, parts)
    small = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=a.dtype)
    for t in range(parts - 1, 0, -1):
        for i in range(t, -1, -1):
            small = small + pa[i] @ pb[t - i]
    return small + pa[0] @ pb[0]


def plain_core(q, k, v, keep, dtype):
    """The core of freq_attention_branch, its own lines."""
    s = round_grad(torch.matmul(q, k.transpose(-1, -2)) * HEAD_DIM**-0.5, dtype)
    p = torch.exp(s - s.amax(-1, keepdim=True).detach())
    l = p.sum(-1, keepdim=True)
    if keep is not None:
        p = p * keep
    return round_value(round_grad(torch.matmul(round_value(p, dtype), v), dtype) / l, dtype)


class TileCore(torch.autograd.Function):
    """The kernels' core: forward as freq_core_fwd_kernel, backward as
    freq_core_bwd_kernel (S and p recomputed), products of `parts`; `seen`
    (a dict) gets the backward's intermediates."""

    @staticmethod
    def forward(ctx, q, k, v, keep, dtype, parts, seen):
        e, l = TileCore.probabilities(q, k, parts)
        f = torch.ones_like(e) if keep is None else keep
        a = _round(e * f, dtype)
        ctx.save_for_backward(q, k, v, f)
        ctx.dtype, ctx.parts, ctx.seen = dtype, parts, seen
        return _round(_mm(a, v, parts) / l, dtype)

    @staticmethod
    def probabilities(q, k, parts):
        s = _mm(q, k.transpose(-1, -2), parts) * QSCALE
        e = torch.exp2(s - s.amax(-1, keepdim=True))
        return e, e.sum(-1, keepdim=True)

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, f = ctx.saved_tensors
        dtype, parts = ctx.dtype, ctx.parts
        e, l = TileCore.probabilities(q, k, parts)
        a = _round(e * f, dtype)
        d_o = _round(d_o, dtype)
        dy = _round(d_o / l, dtype)
        da = _mm(dy, v.transpose(-1, -2), parts)
        delta = (d_o * _mm(a, v, parts)).sum(-1, keepdim=True) / (l * l)
        exact = e * (f * da - delta)
        ds = _round(exact, dtype)
        if ctx.seen is not None:
            ctx.seen.update(ds=ds, exact=exact, e=e, f=f, da=da, a=a, l=l)
        dq = _mm(ds, k, parts) * SCALE
        dk = _mm(ds.transpose(-1, -2), q, parts) * SCALE
        dv = _mm(a.transpose(-1, -2), dy, parts)
        return dq, dk, dv, None, None, None, None


def branch(x32, attn, rope_cos, rope_sin, f, dtype, rate, seed, core):
    """ops/fused_freq.py:freq_attention_branch with its core `core(q, k, v,
    keep, dtype)`."""
    rows, c = x32.shape
    items, heads = rows // f, c // HEAD_DIM
    acc = x32.dtype
    on = rate > 0.0 and seed is not None
    g = round_value(rms_norm(x32, attn.norm.gamma), dtype)
    z = round_grad(F.linear(g, attn.to_gates.weight.to(acc)), dtype) + attn.to_gates.bias.to(acc)
    gates = round_value(torch.sigmoid(z), dtype)
    w = round_value(attn.to_qkv.weight.to(acc), dtype)
    qkv = round_value(round_grad(F.linear(g, w), dtype), dtype)
    qkv = qkv.reshape(items, f, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
    cos, sin = rope_cos[:f].to(acc), rope_sin[:f].to(acc)
    q = round_value(apply_rope(qkv[0], cos, sin), dtype)
    k = round_value(apply_rope(qkv[1], cos, sin), dtype)
    keep = None
    if on:
        keep = drop.keep_mask(seed, drop.SALT_FREQ, drop.SITE_ATTN_PROBS, items, heads, f, f,
                              rate, x32.device).to(acc)
    o = core(q, k, qkv[2], keep, dtype)
    go = round_value(o * gates.reshape(items, f, heads).transpose(1, 2)[..., None], dtype)
    go = go.transpose(1, 2).reshape(rows, c)
    out = round_grad(F.linear(go, round_value(attn.to_out[0].weight.to(acc), dtype)), dtype)
    if on:
        out = out * rows_mask(seed, drop.SALT_FREQ, drop.SITE_ATTN_OUT, out, rate)
    return out


def block(x, attn, ff, cos, sin, rate, dtype, core):
    """fused_freq_roformer_train_ref over x (items, F, C) in the accumulation
    dtype of x, rounding points of `dtype`, the attention core `core`."""
    items, f, c = x.shape
    x32 = x.reshape(items * f, c)
    x2 = x32 + branch(x32, attn, cos, sin, f, dtype, rate, SEED, core)
    out = x2 + ff_ops.ff_train_branch(x2, ff, dtype, rate, SEED, drop.SALT_FREQ)
    return out.reshape(items, f, c)


def _modules(c: int, seed: int):
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


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _case(c: int, f: int, items: int, seed: int):
    attn, ff = _modules(c, seed)
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((items, f, c)))
    cot = torch.from_numpy(rng.standard_normal((items, f, c)))
    return attn, ff, x, cot, rope_tables(f, 32, torch.device("cpu"))


def _grads(attn, ff, x, cot, tables, rate, acc, dtype, core):
    """Output, dx and the ten parameter gradients of sum(block(x) cot), the
    modules and x in the accumulation dtype `acc`."""
    attn, ff = attn.to(acc), ff.to(acc)
    params = list(attn.parameters()) + list(ff.parameters())
    cos, sin = (t.to(acc) for t in tables)
    xw = x.to(acc).requires_grad_(True)
    out = block(xw, attn, ff, cos, sin, rate, dtype, core)
    out = round_value(out, dtype)
    return [out.detach()] + list(torch.autograd.grad(out, [xw] + params, cot.to(acc)))


def _tile(parts, seen=None):
    return lambda q, k, v, keep, dtype: TileCore.apply(q, k, v, keep, dtype, parts, seen)


NAMES = ["out", "dx", "dgamma", "dWqkv", "dWgates", "dgate_b", "dWout", "dgamma_ff", "dW1",
         "db1", "dW2", "db2"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_the_copied_branch_is_the_plain_version(dtype):
    """`branch` with the plain core gives freq_attention_branch's bits."""
    c, f, items = 64, 8, 5
    attn, _, x, _, (cos, sin) = _case(c, f, items, 3)
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    attn = attn.to(acc)
    x32 = x.to(acc).reshape(items * f, c)
    want = freq_ops.freq_attention_branch(x32, attn, cos, sin, f, dtype, 0.1, SEED)
    got = branch(x32, attn, cos, sin, f, dtype, 0.1, SEED, plain_core)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("c,f,items", [(32, 32, 3), (64, 16, 5), (128, 8, 9), (64, 1, 40)])
def test_three_parts_hold_the_float32_limit(c, f, items, rate):
    """With CORE_PARTS parts the output, dx and the ten parameter gradients
    stay within 1e-4 of float64 and of the float32 plain version, as the
    float32 plain version stays within 1e-4 of float64."""
    attn, ff, x, cot, tables = _case(c, f, items, c + f)
    exact = _grads(attn, ff, x, cot, tables, rate, torch.float64, torch.float64, plain_core)
    plain = _grads(attn, ff, x, cot, tables, rate, torch.float32, torch.float32, plain_core)
    got = _grads(attn, ff, x, cot, tables, rate, torch.float32, torch.float32,
                 _tile(CORE_PARTS))
    for name, g, p, w in zip(NAMES, got, plain, exact):
        assert _rel(p, w) < F32_LIMIT / 10, name
        assert _rel(g, w) < F32_LIMIT / 10, (name, _rel(g, w))
        assert _rel(g, p) < F32_LIMIT / 10, (name, _rel(g, p))


def test_two_parts_drift_the_gate_bias():
    """The gate bias's gradient sums d_z over every row, and d_z = (d_og .
    o) sig (1 - sig) cancels: with two parts per operand in the core it
    lands several times further from float64 than with three, over a few
    seeds at F 8, C 128 with dropout."""
    c, f, items, rate = 128, 8, 37, 0.1
    errs = {2: [], 3: []}
    for seed in range(3):
        attn, ff, x, cot, tables = _case(c, f, items, 100 + seed)
        exact = _grads(attn, ff, x, cot, tables, rate, torch.float64, torch.float64, plain_core)
        for parts in errs:
            got = _grads(attn, ff, x, cot, tables, rate, torch.float32, torch.float32,
                         _tile(parts))
            errs[parts].append(_rel(got[NAMES.index("dgate_b")], exact[NAMES.index("dgate_b")]))
    assert 3 * max(errs[3]) < min(errs[2]), errs


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("c,f,items", [(32, 32, 3), (128, 8, 9), (64, 2, 20)])
def test_bfloat16_emulation_holds_the_bf16_limit(c, f, items, rate):
    attn, ff, x, cot, tables = _case(c, f, items, c + f + 1)
    plain = _grads(attn, ff, x, cot, tables, rate, torch.float32, torch.bfloat16, plain_core)
    got = _grads(attn, ff, x, cot, tables, rate, torch.float32, torch.bfloat16, _tile(1))
    for name, g, p in zip(NAMES, got, plain):
        assert _rel(g, p) < BF16_LIMIT, (name, _rel(g, p))


def test_natural_log_ds_has_the_plain_versions_bits():
    """On the same q, k, v, keep factors and bf16 cotangent of o, the
    kernels' ds (rounded in natural-log units) equals the plain version's
    rounded score cotangent on nearly every element; B12's base-2 form,
    round(ln2 ds) / ln2, on hardly any, and delta taken from dY (sum A dA /
    l) on far fewer."""
    rng = np.random.default_rng(0)
    items, heads, f = 64, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((items, heads, f, HEAD_DIM)))
               .float().to(torch.bfloat16).float() for _ in range(3))
    keep = torch.from_numpy(np.where(rng.random((items, heads, f, f)) >= 0.1, 1 / 0.9, 0.0)
                            ).float()
    d_o = torch.from_numpy(rng.standard_normal((items, heads, f, HEAD_DIM))).float()
    d_o = d_o.to(torch.bfloat16).float()
    seen = {}
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    torch.autograd.grad(_tile(1, seen)(qs, ks, vs, keep, torch.bfloat16), [qs], d_o)
    scores = {}

    def hooked(q, k, v, keep, dtype):
        s = torch.matmul(q, k.transpose(-1, -2)) * HEAD_DIM**-0.5
        s.register_hook(lambda g: scores.update(ds=g))
        s = round_grad(s, dtype)
        p = torch.exp(s - s.amax(-1, keepdim=True).detach())
        l = p.sum(-1, keepdim=True)
        return round_value(round_grad(torch.matmul(round_value(p * keep, dtype), v), dtype) / l,
                           dtype)

    qp, kp, vp = (t.clone().requires_grad_(True) for t in (q, k, v))
    torch.autograd.grad(hooked(qp, kp, vp, keep, torch.bfloat16), [qp], d_o)
    want, ds = scores["ds"], seen["ds"]
    base2 = (LN2 * seen["exact"]).to(torch.bfloat16).float() / LN2
    live = want != 0
    from_dy = _round(seen["e"] * (seen["f"] * seen["da"] - (seen["a"] * seen["da"]).sum(
        -1, keepdim=True) / seen["l"]), torch.bfloat16)
    assert float((ds == want)[live].float().mean()) > 0.999
    assert float((base2 == want)[live].float().mean()) < 0.01
    assert float((from_dy == want)[live].float().mean()) < 0.9
