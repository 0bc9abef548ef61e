"""The design of the frequency block's training backward (B7,
`beat_this_tpu_torch/csrc/fused_freq_train.cu`) and of the feed-forward
training forward (B8, `csrc/ff_train.cuh`), checked on the CPU before the
card:

- B7 runs the feed-forward half first, as the feed-forward backward's own
  launches on the unrounded residual x2 = x + attention branch (float32 in
  every compute dtype) under the frequency block's salt, then the attention
  branch's backward with d_x2 as its cotangent; the plain gradients of
  `fused_freq_roformer_train_ref` are that composition, at every frequency
  shape of the model, with dropout on;
- B7 takes its float32 products in three bf16 parts per operand (six bf16
  products): the gate bias's gradient, a sum over rows that cancels, then
  stays within float32's own error of float64, where two parts per operand
  (as B5 and B9 take them) leave an error ten times larger;
- B8 takes the two products of the feed-forward residual in float32 as
  bf16 products of three-part operands: within float32's own error of
  float64 at the main and frontend widths, as the plain version is, where
  two parts per operand leave twenty times more (enough to move the first
  training step's frontend gradients, whose sums over rows cancel, past
  1e-3 on the card) and one bf16 product misses 1e-3.

The plain versions are held to the Pallas kernels in
tests/test_torch_freq_train.py and tests/test_torch_train_kernels_ref.py,
the kernels to the plain versions in tests/test_torch_cuda_kernels.py.

Tolerances: the composition equals the whole to float rounding (1e-12 in
float64, 1e-6 in float32 arithmetic with bf16 rounding points: the same
operations in another graph); relative to each result's largest entry, the
three-part forward within 1e-6 of float64, two parts over 2e-6, one bf16
product per step over 1e-3.
"""

from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from beat_this_tpu_torch.model.layers import Attention, FeedForward, rms_norm, rows_mask, wide
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops import fused_ff as ff_ops
from beat_this_tpu_torch.ops import fused_freq as freq_ops
from beat_this_tpu_torch.ops.rotary import rope_tables

RATE = 0.2


def _modules(c: int, seed: int, dtype: torch.dtype):
    """An Attention and a FeedForward at width c with numpy-seeded weights."""
    rng = np.random.default_rng(seed)
    attn, ff = Attention(c, c // 32), FeedForward(c)
    with torch.no_grad():
        for p in list(attn.parameters()) + list(ff.parameters()):
            fan_in = p.shape[-1] if p.ndim == 2 else 1
            scale = 1 / np.sqrt(fan_in) if p.ndim == 2 else 0.1
            p.copy_(torch.from_numpy((scale * rng.standard_normal(p.shape)).astype(np.float32)))
        attn.norm.gamma.add_(1.0)
        ff.net[0].gamma.add_(1.0)
    return attn.to(dtype), ff.to(dtype)


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.bfloat16, 1e-6)])
@pytest.mark.parametrize("c,f", [(32, 32), (64, 16), (128, 8)])
def test_backward_is_the_ff_half_then_the_attention_branch(c, f, dtype, tol):
    items, seed = 3, 11
    attn, ff = _modules(c, c + f, torch.float64 if dtype == torch.float64 else torch.float32)
    params = list(attn.parameters()) + list(ff.parameters())
    rng = np.random.default_rng(f)
    x = torch.from_numpy(rng.standard_normal((items, f, c))).to(dtype)
    cot = torch.from_numpy(rng.standard_normal((items, f, c))).to(dtype)
    cos, sin = rope_tables(f, 32, torch.device("cpu"))

    # the whole block through autograd
    xw = x.clone().requires_grad_(True)
    out = freq_ops.fused_freq_roformer_train_ref(xw, attn, ff, cos, sin, RATE, seed)
    whole = torch.autograd.grad(out, [xw] + params, cot)

    # the kernel's order: the FF half on a leaf x2, then the attention branch
    x32 = wide(x).reshape(items * f, c).requires_grad_(True)
    branch = freq_ops.freq_attention_branch(x32, attn, cos, sin, f, dtype, RATE, seed)
    x2 = (x32 + branch).detach().requires_grad_(True)
    assert x2.dtype == (torch.float64 if dtype == torch.float64 else torch.float32)
    y = x2 + ff_ops.ff_train_branch(x2, ff, dtype, RATE, seed, drop.SALT_FREQ)
    ff_params = list(ff.parameters())
    d_x2, *ff_grads = torch.autograd.grad(y.to(dtype), [x2] + ff_params,
                                         cot.reshape(items * f, c))
    dx_attn, *attn_grads = torch.autograd.grad(branch, [x32] + list(attn.parameters()), d_x2)
    parts = [(d_x2 + dx_attn).to(dtype).reshape(items, f, c)] + attn_grads + ff_grads

    for i, (a, b) in enumerate(zip(parts, whole)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert _rel(a, b) <= tol, (i, _rel(a, b))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _parts(t: torch.Tensor, parts: int) -> list:
    """t as `parts` bf16 parts, each rounding what the ones before leave."""
    out = []
    for _ in range(parts):
        out.append(_bf16(t))
        t = t - out[-1]
    return out


def _mm(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a @ b in float32 as the kernels' products take it (tc_product.cuh):
    the bf16 products of parts i, j with i + j < parts, the small terms
    first."""
    ap, bp = _parts(a, parts), _parts(b, parts)
    out = torch.zeros(a.shape[0], b.shape[1], dtype=a.dtype)
    for t in range(parts - 1, -1, -1):
        for i in range(t, -1, -1):
            out = out + ap[i] @ bp[t - i]
    return out


class _Linear(torch.autograd.Function):
    """F.linear whose forward and backward products are `_mm` of `parts`."""

    @staticmethod
    def forward(ctx, a, w, parts):
        ctx.save_for_backward(a, w)
        ctx.parts = parts
        return _mm(a, w.T, parts)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        return _mm(g, w, ctx.parts), _mm(g.T, a, ctx.parts), None


def _split_linear(parts: int, gates: int):
    """A stand-in for F.linear in float32 with the kernels' products: the
    gate logits' product (H rows of weights) exact, as B7 takes it on
    float32 FMAs; float64 untouched."""
    exact = F.linear

    def linear(a, w, b=None):
        if a.dtype == torch.float64 or w.shape[0] == gates:
            return exact(a, w, b)
        out = _Linear.apply(a, w, parts)
        return out if b is None else out + b

    return linear


def test_three_part_products_hold_the_gate_bias_gradient():
    """At F 8, C 128 over 37 items with dropout, the block's gradients with
    every product in three parts stay within 1e-6 of float64 relative to
    each gradient's largest entry, and the gate bias's is ten times closer
    than with two parts per operand."""
    f, c, items = 8, 128, 37
    cos, sin = rope_tables(f, 32, torch.device("cpu"))
    errs = {2: [], 3: []}
    for seed in range(3):
        attn, ff = _modules(c, 1000 + seed, torch.float64)
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal((items, f, c)))
        cot = torch.from_numpy(rng.standard_normal((items, f, c)))

        def grads(dtype):
            attn.to(dtype)
            ff.to(dtype)
            xw = x.to(dtype).requires_grad_(True)
            out = freq_ops.fused_freq_roformer_train_ref(xw, attn, ff, cos, sin, RATE, 13)
            return torch.autograd.grad(out, [xw] + list(attn.parameters()), cot.to(dtype))

        exact = grads(torch.float64)
        for parts in errs:
            with mock.patch.object(F, "linear", _split_linear(parts, c // 32)):
                got = grads(torch.float32)
            if parts == 3:
                assert max(_rel(a, b) for a, b in zip(got, exact)) < 1e-6
            errs[parts].append(float((got[4].double() - exact[4]).abs().max()))
    assert 10 * max(errs[3]) < min(errs[2])


def _ff_forward(x, ff, mm, seed):
    """B8's forward with the products `mm`: g, h1d = gelu(g W1^T + b1) f and
    out = x + (h1d W2^T + b2) f, in the dtype of x."""
    norm, lin1, _, _, lin2, _ = ff.net
    acc = x.dtype
    g = rms_norm(x, norm.gamma.to(acc))
    h = F.gelu(mm(g, lin1.weight.to(acc).T) + lin1.bias.to(acc))
    h = h * rows_mask(seed, drop.SALT_FF, drop.SITE_FF_HIDDEN, h, RATE)
    y = mm(h, lin2.weight.to(acc).T) + lin2.bias.to(acc)
    return x + y * rows_mask(seed, drop.SALT_FF, drop.SITE_FF_OUT, y, RATE)


@pytest.mark.parametrize("rows,c", [(192, 512), (600, 32), (400, 64), (300, 128)])
def test_ff_forward_three_part_products_hold_float32(rows, c):
    seed = 5
    _, ff = _modules(c, rows + c, torch.float32)
    x = torch.from_numpy(np.random.default_rng(c).standard_normal((rows, c)).astype(np.float32))
    with torch.no_grad():
        want = _ff_forward(x.double(), ff, lambda a, b: a @ b, seed)
        got = {p: _ff_forward(x, ff, lambda a, b, p=p: _mm(a, b, p), seed) for p in (1, 2, 3)}
        plain = ff_ops.fused_ff_train_ref(x, ff, RATE, seed)
    assert _rel(plain, want) < 1e-6  # the emulation is the plain version's function
    assert _rel(got[3], want) < 1e-6
    assert _rel(got[2], want) > 2e-6  # why float32 takes three parts
    # the branch alone (out - x): one bf16 product per step misses 1e-3 of it
    assert _rel(got[1] - x, want - x.double()) > 1e-3
