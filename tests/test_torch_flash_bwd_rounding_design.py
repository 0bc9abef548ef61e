"""Where the flash-attention backward (B11, `csrc/flash_attention.cu`:
`flash_dq_kernel`, `flash_dkv_kernel`) rounds dS, checked on the CPU: its
dataflow emulated in torch (q rotated and scaled by D^-0.5 log2(e), k
rotated, both rounded to the input type; p = exp2(s - lse) from the
forward's base-2 log-sum-exp; delta = rowsum(dout * o) from the wrapper;
every product in float32, bfloat16 operands exact), against the plain
version `flash_attention_ref`, whose autograd rounds the gradient of the
base-2 scores to the input type (`round_grad` on s).

- In bfloat16 the kernels form dS = ln 2 p (dp f - delta) in float32 and
  round that, the plain version's rounding point: with delta from the
  unrounded output, as the plain version's autograd forms it, dS then holds
  the plain version's bits but where the two sums' orders tip a rounding.
  The old order, p (dp f - delta) rounded and ln 2 applied at the dk store
  (dq's through D^-0.5 = ln 2 D^-0.5 log2(e)), rounds another number and
  matches none of them.
- The wrapper forms delta = rowsum(dout * o) from the stored output, which
  bfloat16 has rounded (the TPU kernel's design, unchanged): where dp f
  nearly cancels delta, that moves dS by more than its rounding, and 9-16%
  of dS's bfloat16 values differ from the plain version's.
- dq, dk and dv from the repaired order agree with the plain version's
  autograd gradients within the card's limits: 2.5e-2 in bfloat16, and in
  float32 (two-part split products, `flash_attention.BWD_PARTS`) 1e-4, the
  training limit of `tests/test_torch_cuda_kernels.py:test_flash_attention`.

The masks are the plain version's own Philox masks. Tolerance: relative max
deviation over each quantity's largest entry.
"""

import math

import numpy as np
import pytest
import torch

from beat_this_tpu_torch.ops import flash_attention as flash_ops
from beat_this_tpu_torch.ops.rotary import apply_rope, rope_tables
from tests.test_torch_small_tc_design import _mm, _rel

LN2 = float(np.float32(math.log(2.0)))
BF16_LIMIT, F32_LIMIT = 2.5e-2, 1e-4
HEADS, SEED = 3, 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(n: int, d: int, dtype: torch.dtype, seed: int):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (torch.from_numpy(rng.standard_normal((HEADS, n, d))).float()
                    for _ in range(4))
    cos, sin = rope_tables(n, d)
    return q.to(dtype), k.to(dtype), v.to(dtype), cot, cos.float(), sin.float()


def _plain(q, k, v, cot, cos, sin, rate, monkeypatch) -> dict:
    """flash_attention_ref's output, its dq, dk, dv of sum(out * cot), and
    the gradient of its base-2 scores as its autograd rounds it."""
    seen = []
    orig = flash_ops.round_grad

    def recording(t, dtype):
        t.register_hook(lambda g: seen.append(g.detach().clone()))
        return orig(t, dtype)

    monkeypatch.setattr(flash_ops, "round_grad", recording)
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = flash_ops._ref_chunk(q, k, v, cos, sin, rate, SEED, HEADS, 0)
    (out.float() * cot).sum().backward()
    return {"o": out.detach(), "ds": seen[0], "dq": q.grad, "dk": k.grad, "dv": v.grad}


def _kernel(q, k, v, dout, cos, sin, keep, parts: int, ln2_first: bool,
            wide_delta: bool = False) -> dict:
    """B10 with lse for every entry, then B11: dS, dq, dk and dv, in the
    dtype of q's rounding (`parts` 1: bfloat16 operands; 2: float32 split in
    two). `ln2_first`: the repaired order (dS holds ln 2 before its
    rounding); else the old one. `wide_delta`: delta from the output before
    its rounding to q's dtype, as the plain version's autograd has it; else
    from the stored output, as the wrapper forms it. dS is returned as the
    products take it (old order: times the ln 2 applied after them)."""
    dtype = q.dtype
    d = q.shape[-1]
    qscale = float(np.float32(d**-0.5 * flash_ops.LOG2E))
    qr = flash_ops.rotated(q, cos, sin, qscale)  # float32, rounded to q's dtype
    kr = flash_ops.rotated(k, cos, sin)
    v32, dout32 = v.float(), dout.float()
    s = _mm(qr, kr.transpose(-1, -2), parts)
    m = s.amax(-1, keepdim=True)
    l = torch.exp2(s - m).sum(-1, keepdim=True)
    lse = m + torch.log2(l)
    pm = torch.exp2(s - m) * keep
    o32 = _mm(pm.to(dtype).float() if dtype == torch.bfloat16 else pm, v32, parts) / l
    if not wide_delta:
        o32 = o32.to(dtype).float()
    p = torch.exp2(s - lse)
    dp = _mm(dout32, v32.transpose(-1, -2), parts)
    delta = (dout32 * o32).sum(-1, keepdim=True)
    x = (LN2 if ln2_first else 1.0) * p * (dp * keep - delta)
    ds = x.to(dtype).float() if dtype == torch.bfloat16 else x
    after = 1.0 if ln2_first else LN2

    def back(g, mul):  # the inverse rotation times mul, stored as the input type
        return (apply_rope(g, cos, -sin) * mul).to(dtype)

    dq = back(_mm(ds, kr, parts), qscale * after)
    dk = back(_mm(ds.transpose(-1, -2), qr, parts), after)
    pf = (p * keep).to(dtype).float() if dtype == torch.bfloat16 else p * keep
    dv = _mm(pf.transpose(-1, -2), dout32, parts).to(dtype)
    return {"ds": ds * after, "dq": dq, "dk": dk, "dv": dv}


def _keep(n: int, rate: float) -> torch.Tensor:
    if rate == 0:
        return torch.ones(HEADS, n, n)
    return flash_ops.probs_keep(SEED, 0, HEADS, HEADS, n, n, rate, "cpu").float()


def _both(n, d, dtype, rate, seed, monkeypatch, parts=1, wide_delta=False) -> tuple:
    q, k, v, cot, cos, sin = _inputs(n, d, dtype, seed)
    want = _plain(q, k, v, cot, cos, sin, rate, monkeypatch)
    dout = cot.to(dtype)  # the cotangent of the output, as the wrapper passes it
    got = {order: _kernel(q, k, v, dout, cos, sin, _keep(n, rate), parts, first, wide_delta)
           for order, first in (("repaired", True), ("old", False))}
    return got, want


def _shares(d: int, rate: float, monkeypatch, wide_delta: bool) -> dict:
    """Per order, the share of dS's entries equal to the plain version's."""
    got, want = _both(200, d, torch.bfloat16, rate, d + int(10 * rate), monkeypatch,
                      wide_delta=wide_delta)
    plain = want["ds"].float()
    assert torch.equal(plain, plain.bfloat16().float())  # the plain version's bf16 bits
    return {order: float((g["ds"] == plain).float().mean()) for order, g in got.items()}


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("d", [16, 32])
def test_repaired_ds_holds_the_plain_versions_bf16_bits(d, rate, monkeypatch):
    share = _shares(d, rate, monkeypatch, wide_delta=True)
    assert share["repaired"] > 0.999, share
    assert share["old"] < 0.01, share


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("d", [16, 32])
def test_delta_from_the_stored_output_tips_some_roundings(d, rate, monkeypatch):
    share = _shares(d, rate, monkeypatch, wide_delta=False)
    assert 0.8 < share["repaired"] < 0.95, share
    assert share["old"] < 0.01, share


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("dtype,parts,limit", [
    pytest.param(torch.bfloat16, 1, BF16_LIMIT, id="bfloat16"),
    pytest.param(torch.float32, flash_ops.BWD_PARTS, F32_LIMIT, id="float32"),
])
def test_repaired_gradients_match_the_plain_version(dtype, parts, limit, d, rate, monkeypatch):
    got, want = _both(130, d, dtype, rate, 7 * d + int(10 * rate), monkeypatch, parts)
    for name in ("dq", "dk", "dv"):
        err = _rel(got["repaired"][name], want[name])
        assert err < limit, (name, err)
