"""The design of the tensor-core small-sequence attention kernels (B12,
forward and backward, `beat_this_tpu_torch/csrc/small_attention.cu`),
checked on the CPU before the card. Their dataflow emulated in torch: the
rows packed into block-diagonal score tiles of 16 keys (F <= 16) or 32
(F = 32), rows past the end of the last 64-row block zero, float32 operands
split into P bf16 parts (the products of parts i, j with i + j < P, the
small terms first), every other step in float32, bfloat16 rounded where the
kernels round, which is where the plain version rounds (q and k after the
rotation, the dropped p, o; in the backward the plain version's autograd:
ds as the gradient of the base-2 scores, dq, dk, dv):

- the forward takes `small_attention.FWD_PARTS` parts, the backward
  `BWD_PARTS`: the chain (S, p, o; dp, delta, ds, dq, dk, dv) then stays
  within 1e-5 of float64 in the forward (the float32 forward's limit,
  `tests/test_torch_cuda_kernels.py:
  test_attention_kernels_take_views_and_refuse_other_shapes`) and 1e-4 in
  the backward (`test_small_attention`); one part fewer misses one of them;
- the emulation equals the plain version `small_attention_ref` (and its
  autograd gradients) within those limits in float32 and within 2.5e-2 in
  bfloat16, on the plain version's own Philox masks (in bfloat16 it gives
  the plain version's bits but where a sum's order tips a rounding).

The masks are given as tensors of keep factors; every F the kernels take
(1, 2, 4, 8, 16, 32), head widths 16 and 32, rates 0 and 0.2, item counts
that leave the last 64-row block part full. Tolerance: relative max
deviation over each quantity's largest entry.
"""

import numpy as np
import pytest
import torch

from beat_this_tpu_torch.ops import flash_attention as flash_ops
from beat_this_tpu_torch.ops import small_attention as small_ops
from beat_this_tpu_torch.ops.rotary import apply_rope, rope_tables

FWD, BWD, DV = small_ops.FWD_PARTS, small_ops.BWD_PARTS, small_ops.DV_PARTS
FWD_LIMIT, BWD_LIMIT, BF16_LIMIT = 1e-5, 1e-4, 2.5e-2
FORWARD = ("S", "p", "o")
LN2 = float(np.float32(np.log(2.0)))
BLOCK_ROWS = 64  # rows of a kernel block


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
    """x as `parts` bf16 values: round(x), then what the parts before leave,
    rounded (csrc/tc_product.cuh: store2)."""
    out = []
    for _ in range(parts):
        out.append(x.to(torch.bfloat16).to(x.dtype))
        x = x - out[-1]
    return out


def _mm(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """Batched a @ b as the kernels take it: the products of parts i, j with
    i + j < parts, the small terms first; float64 untouched."""
    if a.dtype == torch.float64:
        return a @ b
    pa, pb = _parts(a, parts), _parts(b, parts)
    small = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=a.dtype)
    for t in range(parts - 1, 0, -1):
        for i in range(t, -1, -1):
            small = small + pa[i] @ pb[t - i]
    return small + pa[0] @ pb[0]


def _tiles(x: torch.Tensor, nk: int) -> torch.Tensor:
    """(items, F, ...) rows as (tiles, nk, ...) score-tile groups, zero rows
    up to the end of the last block."""
    flat = x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])
    pad = -flat.shape[0] % BLOCK_ROWS
    flat = torch.cat([flat, flat.new_zeros(pad, *flat.shape[1:])])
    return flat.reshape(-1, nk, *flat.shape[1:])


def _untile(x: torch.Tensor, items: int, f: int) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])[: items * f].reshape(items, f, -1)


def _keep_tiles(keep: torch.Tensor, nk: int) -> torch.Tensor:
    """(items, F, F) keep factors as block-diagonal (tiles, nk, nk) tiles."""
    items, f, _ = keep.shape
    per = nk // f
    pad = -(items * f) % BLOCK_ROWS // f
    keep = torch.cat([keep, keep.new_ones(pad, f, f)]).reshape(-1, per, f, f)
    full = keep.new_zeros(keep.shape[0], per, f, per, f)
    for i in range(per):
        full[:, i, :, i, :] = keep[:, i]
    return full.reshape(-1, nk, nk)


def _chain(q, k, v, dout, keep, cos, sin, dtype, fwd: int, bwd: int) -> dict:
    """B12's forward, then its backward, over q, k, v, dout (items, F, D) in
    the computing dtype (float64: the reference; float32: the kernels in
    `dtype`), products from `fwd` / `bwd` parts. Returns every quantity the
    kernels form, the per-row ones as (items, F, ...)."""
    items, f, d = q.shape
    nk = 16 if f <= 16 else 32
    qscale = float(np.float32(d**-0.5 * flash_ops.LOG2E))
    qr = apply_rope(q, cos, sin) if cos is not None else q
    kr = apply_rope(k, cos, sin) if cos is not None else k
    qs, kt = (_tiles(t, nk) for t in (_round(qr * qscale, dtype), _round(kr, dtype)))
    vt, dt = _tiles(v, nk), _tiles(dout, nk)
    kf = _keep_tiles(keep.to(q.dtype), nk)
    pos = torch.arange(nk)
    same = (pos[:, None] // f == pos[None, :] // f)

    def probs(parts):
        s = _mm(qs, kt.transpose(-1, -2), parts).masked_fill(~same, -torch.inf)
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        return s.masked_fill(~same, 0.0), p, p.sum(-1, keepdim=True)

    s, p, l = probs(fwd)
    o = _round(_mm(_round(p * kf, dtype), vt, fwd) / l, dtype)
    # the backward rounds where the plain version's autograd rounds: pf =
    # round(p f) (unnormalized), delta = sum pf dp / l, ds = round(ln2 (p / l)
    # (f dp - delta)); dq = ds K qscale, dk = ds^T Q (the scaled q), dv = pf^T
    # (dout / l), that product in DV parts whatever the dtype
    _, pb, lb = probs(bwd)
    dp = _mm(dt, vt.transpose(-1, -2), bwd)
    pf = _round(pb * kf, dtype)
    delta = (pf * dp).sum(-1, keepdim=True) / lb
    ds = _round(LN2 * (pb / lb) * (kf * dp - delta), dtype)

    def pulled_back(g, mul):
        g = _untile(g, items, f)
        return _round((apply_rope(g, cos, -sin) if cos is not None else g) * mul, dtype)

    dq = pulled_back(_mm(ds, kt, bwd), qscale)
    dk = pulled_back(_mm(ds.transpose(-1, -2), qs, bwd), 1.0)
    dv = _round(_untile(_mm(pf.transpose(-1, -2), dt / lb, DV if bwd else 0), items, f), dtype)
    return {"S": s, "p": p / l, "o": _untile(o, items, f), "dp": kf * dp, "delta": delta,
            "ds": ds, "dq": dq, "dk": dk, "dv": dv}


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _inputs(items: int, f: int, d: int, rate: float, seed: int, rope: bool = True):
    """q, k, v, dout (items, F, D), keep factors (items, F, F) at `rate` and the
    rotation tables, float64, from a numpy seed."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((items, f, d))) for _ in range(4))
    keep = torch.from_numpy(np.where(rng.random((items, f, f)) >= rate, 1.0 / (1.0 - rate), 0.0))
    cos, sin = (t.double() for t in rope_tables(f, d)) if rope else (None, None)
    return q, k, v, dout, keep, cos, sin


def _errors(items, f, d, rate, seed, fwd, bwd) -> dict:
    args = _inputs(items, f, d, rate, seed)
    want = _chain(*args, dtype=torch.float64, fwd=0, bwd=0)
    got = _chain(*(None if t is None else t.float() for t in args), dtype=torch.float32,
                 fwd=fwd, bwd=bwd)
    return {name: _rel(got[name], want[name]) for name in want}


def _items(f: int) -> int:
    """Items whose rows leave the last 64-row block part full."""
    return 3 * BLOCK_ROWS // f + 1


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("f", small_ops.SUPPORTED_SEQ)
def test_chosen_parts_hold_the_float32_limits(f, d, rate):
    errs = _errors(_items(f), f, d, rate, 10 * f + d, FWD, BWD)
    for name, err in errs.items():
        assert err < (FWD_LIMIT if name in FORWARD else BWD_LIMIT), (name, err)


def test_one_part_fewer_misses_a_limit():
    """FWD - 1 parts in the forward put S, p or o past 1e-5 of float64, BWD - 1
    parts in the backward put a gradient past 1e-4, over a few seeds at the
    model's shapes."""
    fwd_worst = bwd_worst = 0.0
    for seed in range(3):
        for f, d in ((32, 16), (16, 16), (8, 16), (32, 32)):
            errs = _errors(_items(f), f, d, 0.1, seed, FWD - 1, BWD - 1)
            fwd_worst = max([fwd_worst] + [errs[n] for n in FORWARD])
            bwd_worst = max([bwd_worst] + [e for n, e in errs.items() if n not in FORWARD])
    assert fwd_worst > FWD_LIMIT
    assert bwd_worst > BWD_LIMIT


def _ref_grads(q, k, v, cot, cos, sin, rate, seed, heads):
    """small_attention_ref's output and dq, dk, dv of sum(out * cot)."""
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = small_ops.small_attention_ref(q, k, v, cos, sin, rate, seed, heads)
    (out.float() * cot).sum().backward()
    return {"o": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype,fwd_limit,bwd_limit", [
    pytest.param(torch.float32, FWD_LIMIT, BWD_LIMIT, id="float32"),
    pytest.param(torch.bfloat16, BF16_LIMIT, BF16_LIMIT, id="bfloat16"),
])
@pytest.mark.parametrize("f,d", [(1, 16), (2, 32), (4, 16), (8, 32), (16, 16), (32, 16),
                                 (32, 32)])
def test_emulation_matches_the_plain_version(f, d, dtype, fwd_limit, bwd_limit, rate, rope):
    """The emulated kernels against small_attention_ref on its own masks
    (Philox, SALT_ATTN, item e at (e // heads, e % heads))."""
    items, heads, seed = _items(f), 3, 11
    q, k, v, dout, _, cos, sin = _inputs(items, f, d, rate, f + d, rope)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    cot = dout.float()
    tables = (cos.float(), sin.float()) if rope else (None, None)
    want = _ref_grads(q, k, v, cot, *tables, rate, seed, heads)
    keep = (flash_ops.probs_keep(seed, 0, items, heads, f, f, rate, "cpu") if rate > 0
            else torch.ones(items, f, f))
    parts = (FWD, BWD) if dtype == torch.float32 else (1, 1)
    got = _chain(q.float(), k.float(), v.float(), _round(cot, dtype), keep, *tables, dtype,
                 *parts)
    for name in ("o", "dq", "dk", "dv"):
        g, w = got[name], want[name].float()
        if f == 1 and name in ("dq", "dk"):
            # one key: the softmax is constant and dq = dk = 0; each side gives the
            # rounding of dp - delta (tests/test_torch_cuda_kernels.py:_compare_qkv)
            assert max(float(g.abs().max()), float(w.abs().max())) < 10 * bwd_limit, name
            continue
        assert _rel(g, w) < (fwd_limit if name == "o" else bwd_limit), (name, _rel(g, w))
