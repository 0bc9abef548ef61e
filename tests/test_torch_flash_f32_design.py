"""The design of the float32 flash-attention kernels (B10, B11 and B14's
modes, `beat_this_tpu_torch/csrc/flash_attention.cu`), checked on the CPU
before the card: their products emulated in torch as the kernels take them,
float32 values split into bf16 parts (P parts: the products of parts i, j
with i + j < P, the small terms first), every other step in float32:

- the forward takes three parts (six products), the backward two (three
  products): the whole chain (S, p, O, lse; dS, dQ, dK, dV) then stays
  within 1e-5 of float64 in the forward (the limit of the forward modes,
  `tests/test_torch_cuda_kernels.py:test_flash_variant`) and 1e-4 in the
  backward (the training limit of `test_flash_attention`); two parts miss
  the forward's limit, and one bf16 product per step misses even the 1e-3
  of `chip_smoke.py`;
- the kNoExp and kMatmulOnly modes, whose sums of raw scores cross zero,
  hold 1e-5 with three parts;
- the forward's first walk takes each row's maximum from one bf16 product
  (the first parts): in float32 nothing is rounded against that maximum,
  so o and lse are those of the exact maximum;
- the wrapper's pre-pass scratch (`ops/flash_attention.py:rotation_scratch`).

The masks are given as tensors of keep factors, the plain versions hold the
kernels on the card (tests/test_torch_cuda_kernels.py). Tolerance: relative
max deviation over each quantity's largest entry.
"""

import math

import numpy as np
import pytest
import torch

from beat_this_tpu_torch.ops import flash_attention as flash_ops
from beat_this_tpu_torch.ops.rotary import apply_rope, rope_tables

FWD, BWD = flash_ops.FWD_PARTS, flash_ops.BWD_PARTS
FWD_LIMIT, BWD_LIMIT, CARD_LIMIT = 1e-5, 1e-4, 1e-3


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _parts(x: torch.Tensor, parts: int) -> list:
    """x as `parts` bf16 values: round(x), then what the parts before leave,
    rounded (csrc/tc_product.cuh: store2)."""
    out = []
    for _ in range(parts):
        out.append(_bf16(x))
        x = x - out[-1]
    return out


def _mm(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a @ b as the kernels take it: the products of parts i, j with i + j
    < parts, the small terms first; float64 untouched."""
    if a.dtype == torch.float64:
        return a @ b
    pa, pb = _parts(a, parts), _parts(b, parts)
    small = torch.zeros(a.shape[0], b.shape[1], dtype=a.dtype)
    for t in range(parts - 1, 0, -1):
        for i in range(t, -1, -1):
            small = small + pa[i] @ pb[t - i]
    return small + pa[0] @ pb[0]


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _inputs(n: int, d: int, rate: float, seed: int):
    """q, k, v, dout (n, d) as the projection of RMS-normed rows gives them,
    the keep factors (n, n) at `rate` and the rotation tables, float64."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((n, d))) for _ in range(4))
    keep = torch.from_numpy(np.where(rng.random((n, n)) >= rate, 1.0 / (1.0 - rate), 0.0))
    cos, sin = (t.double() for t in rope_tables(n, d))
    return q, k, v, dout, keep, cos, sin


def _chain(q, k, v, dout, keep, cos, sin, fwd: int, bwd: int, first: int):
    """B10 with lse, then B11, for one entry, in the dtype of q: the
    pre-pass's rotated, scaled q and rotated k; the forward's maximum from
    `first` parts, S, p and O from `fwd` parts; the backward's products from
    `bwd` parts. Returns every intermediate the kernels form."""
    d = q.shape[-1]
    qr = apply_rope(q, cos, sin) * (d**-0.5 * math.log2(math.e))
    kr = apply_rope(k, cos, sin)
    m = _mm(qr, kr.T, first).amax(-1, keepdim=True)  # walk 1
    s = _mm(qr, kr.T, fwd)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    o = _mm(p * keep, v, fwd) / l
    lse = m + torch.log2(l)
    # the backward: delta = rowsum(dout * o) from the wrapper, p = exp2(s - lse)
    sb = _mm(qr, kr.T, bwd)
    pb = torch.exp2(sb - lse)
    dp = _mm(dout, v.T, bwd)
    # dS, the gradient of the base-2 scores, holds ln 2; qr holds D^-0.5 log2(e)
    ds = math.log(2) * pb * (dp * keep - (dout * o).sum(-1, keepdim=True))
    dq = apply_rope(_mm(ds, kr, bwd) * (d**-0.5 * math.log2(math.e)), cos, -sin)
    dk = apply_rope(_mm(ds.T, qr, bwd), cos, -sin)
    dv = _mm((pb * keep).T, dout, bwd)
    return {"S": s, "probs": p / l, "O": o, "lse": lse, "dS": ds, "dQ": dq, "dK": dk, "dV": dv}


FORWARD = ("S", "probs", "O", "lse")


def _errors(n, d, rate, seed, fwd, bwd, first=1):
    args = _inputs(n, d, rate, seed)
    want = _chain(*args, fwd=0, bwd=0, first=0)
    got = _chain(*(t.float() for t in args), fwd=fwd, bwd=bwd, first=first)
    return {name: _rel(got[name], want[name]) for name in want}


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("n", [65, 1500])
@pytest.mark.parametrize("d", [16, 32])
def test_chosen_parts_hold_the_float32_limits(d, n, rate):
    errs = _errors(n, d, rate, n + d, FWD, BWD)
    for name, err in errs.items():
        assert err < (FWD_LIMIT if name in FORWARD else BWD_LIMIT), (name, err)
    # why float32 needs the split: one bf16 product per step misses the card's limit
    one = _errors(n, d, rate, n + d, 1, 1)
    assert max(one.values()) > CARD_LIMIT


def test_two_parts_miss_the_forward_limit():
    """Three bf16 products of two-part operands (about 16 bits) put the
    forward's output about 1e-5 from float64: over a few seeds at the
    shapes of test_flash_variant they pass its limit, three parts stay 20
    times under it."""
    two, three = [], []
    for seed in range(4):
        for n, d in ((77, 16), (200, 32), (256, 32)):
            two.append(_errors(n, d, 0.0, seed, 2, 2)["O"])
            three.append(_errors(n, d, 0.0, seed, 3, 3)["O"])
    assert max(two) > FWD_LIMIT
    assert max(three) < FWD_LIMIT / 20


def _raw_modes(q, k, v, parts: int):
    """kNoExp (o = S V / sum(S), and the denominators) and kMatmulOnly (S V
    over a count of blocks) over unscaled rotated q, k."""
    s = _mm(q, k.T, parts)
    num = _mm(s, v, parts)
    return num, s.sum(-1, keepdim=True), num / 2.0


@pytest.mark.parametrize("n,d", [(65, 16), (200, 32), (1500, 16), (1500, 32)])
def test_raw_score_modes_hold_the_forward_limit_in_three_parts(n, d):
    q, k, v, _, _, cos, sin = _inputs(n, d, 0.0, 7 * n + d)
    qr = apply_rope(q, cos, sin) * (d**-0.5 * math.log2(math.e))
    kr = apply_rope(k, cos, sin)
    want = _raw_modes(qr, kr, v, 0)
    errs = {}
    for parts in (2, 3):
        num, den, mxu = _raw_modes(qr.float(), kr.float(), v.float(), parts)
        # as test_flash_variant holds noexp: the numerators on every row, o on the
        # rows whose denominator is not near zero
        away = (want[1].abs() >= 0.25 * want[1].abs().max())[:, 0]
        errs[parts] = max(_rel(num, want[0]), _rel(den, want[1]), _rel(mxu, want[2]),
                          _rel((num / den)[away], (want[0] / want[1])[away]))
    assert errs[3] < FWD_LIMIT / 10, errs
    assert errs[2] > errs[3] * 10, errs


def test_first_walk_maximum_from_one_bf16_product():
    """Walk 1 takes m from the first parts alone; p = exp2(s - m) may then
    exceed 1, but o = sum(p f v) / sum(p) and lse = m + log2(sum(p)) are
    those of the exact maximum within float32's rounding."""
    q, k, v, dout, keep, cos, sin = (t.float() for t in _inputs(1500, 16, 0.2, 11))
    approx = _chain(q, k, v, dout, keep, cos, sin, FWD, BWD, first=1)
    exact = _chain(q, k, v, dout, keep, cos, sin, FWD, BWD, first=FWD)
    d = q.shape[-1]
    qr = apply_rope(q, cos, sin) * (d**-0.5 * math.log2(math.e))
    s = _mm(qr, apply_rope(k, cos, sin).T, FWD)
    m1 = _mm(qr, apply_rope(k, cos, sin).T, 1).amax(-1)
    assert float((m1 - s.amax(-1)).abs().max()) > 0  # the maxima differ ...
    for name in ("O", "lse", "probs"):
        assert _rel(approx[name], exact[name]) < 1e-6, name  # ... the results do not


@pytest.mark.parametrize("dtype,fwd_planes,bwd_planes", [(torch.float32, 9, 8),
                                                         (torch.bfloat16, 2, 2)])
def test_rotation_scratch_holds_the_parts(dtype, fwd_planes, bwd_planes):
    """float32: q, k, v as three parts each in the forward, q, k, v and dout
    as two in the backward; bfloat16: the rotated q and k."""
    q = torch.zeros((3, 65, 16), dtype=dtype)
    for backward, planes in ((False, fwd_planes), (True, bwd_planes)):
        scratch = flash_ops.rotation_scratch(q, backward)
        assert scratch.dtype == torch.bfloat16
        assert scratch.shape == (planes, *q.shape)
    assert (FWD, BWD) == (3, 2)
