"""The design of the eval kernels on the tensor cores, K2 (the time block,
`beat_this_tpu_torch/csrc/fused_time.cu`) and K1 (the feed-forward residual,
`csrc/fused_ff.cu`), checked on the CPU before the card: their products
emulated in torch as the kernels take them, bf16 operands with float32
sums, float32 values split into bf16 parts (two parts: a_lo b_hi + a_hi
b_lo + a_hi b_hi; one part in bfloat16), and the rounding points the
kernels keep:

- the gates from the unrounded float32 normed rows, the normed rows
  rounded to T before the q/k/v product;
- RoPE in the q/k/v product's epilogue on the float32 product, q, k, v
  rounded once after it;
- the attention core in two walks (each query's maximum first), p
  rounded to T before P V, l summing the unrounded p, the gated head
  output rounded to T;
- y1 = x + the out projection kept in float32;
- B8's rate-0 forward on y1 (`ff_train.cuh`: g and h rounded to T, the
  pre-activation in float32, out rounded once); K1 is the same on x.

Tolerances: two parts within 1e-4 of float64 relative to the largest entry
(the bar of tests/test_torch_ff_bwd_design.py), where one bf16 part misses
1e-3; the emulation within the card's limits of the plain versions
(`fused_time_roformer_ref`, `fused_ff_ref`): 1e-3 in float32, 2.5e-2 in
bfloat16. The kernels are held to the plain versions on the card in
tests/test_torch_cuda_kernels.py; the scratch layouts live in the CUDA
sources, whose sizes the wrappers ask the library for (GPU test
`test_eval_scratch_holds_the_operands`).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from beat_this_tpu_torch.model.layers import Attention, FeedForward, rms_norm
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops.fused_ff import ff_train_branch, fused_ff_ref
from beat_this_tpu_torch.ops.fused_time import fused_time_roformer_ref
from beat_this_tpu_torch.ops.rotary import apply_rope, rope_tables

QSCALE = 32**-0.5 * math.log2(math.e)  # the kernels' base-2 softmax scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _mm(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a @ b in float32 as the kernels' products take it: the small terms
    a_lo b_hi + a_hi b_lo, then a_hi b_hi (two parts), or a_hi b_hi (one)."""
    ah, bh = _bf16(a), _bf16(b)
    if parts == 1:
        return ah @ bh
    al, bl = _bf16(a - ah), _bf16(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _round(dtype):
    return _bf16 if dtype == torch.bfloat16 else (lambda t: t)


def _ff_emulated(y1: torch.Tensor, ff: FeedForward, dtype, parts: int) -> torch.Tensor:
    """B8's forward at rate 0 on float32 rows y1 (K1 on x, K2's tail on y1),
    in float32 before the output's one rounding."""
    norm, lin1, _, _, lin2, _ = ff.net
    r = _round(dtype)
    g = r(rms_norm(y1, norm.gamma.float()))
    h = r(F.gelu(_mm(g, lin1.weight.float().T, parts) + lin1.bias.float()))
    return y1 + _mm(h, lin2.weight.float().T, parts) + lin2.bias.float()


def _block_emulated(x, attn: Attention, ff: FeedForward, cos, sin, heads: int,
                    parts: int) -> torch.Tensor:
    """K2's launches on x of dtype T, in float32 before the output's one
    rounding."""
    r = _round(x.dtype)
    b, n, c = x.shape
    x32 = x.float()
    gn = rms_norm(x32, attn.norm.gamma.float())  # float32 normed rows
    gates = torch.sigmoid(gn @ attn.to_gates.weight.float().T + attn.to_gates.bias.float())
    qkv = _mm(r(gn), attn.to_qkv.weight.float().T, parts)
    qkv = qkv.reshape(b, n, 3, heads, 32).permute(2, 0, 3, 1, 4)
    q = r(apply_rope(qkv[0], cos[:n], sin[:n]))  # RoPE on the float32 product
    k = r(apply_rope(qkv[1], cos[:n], sin[:n]))
    v = r(qkv[2])
    s = _mm(q, k.transpose(-1, -2), parts) * QSCALE  # the scale on the float32 product
    p = torch.exp2(s - s.amax(-1, keepdim=True))  # walk 1 gives the maximum
    o = _mm(r(p), v, parts) / p.sum(-1, keepdim=True)
    go = r(o * gates.transpose(1, 2)[..., None]).transpose(1, 2).reshape(b, n, c)
    y1 = x32 + _mm(go, attn.to_out[0].weight.float().T, parts)  # float32
    return _ff_emulated(y1, ff, x.dtype, parts)


def _block(c: int, heads: int, seed: int):
    """An Attention and a FeedForward with numpy-seeded weights at the
    scales of the GPU tests."""
    rng = np.random.default_rng(seed)
    attn, ff = Attention(c, heads), FeedForward(c)
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


@pytest.mark.parametrize("c,n,items", [(64, 150, 2), (128, 333, 1)])
def test_eval_block_split_products(c, n, items):
    heads = c // 32
    attn, ff = _block(c, heads, c + n)
    cos, sin = rope_tables(n, 32)
    x = _x((items, n, c), n)
    with torch.no_grad():
        want64 = fused_time_roformer_ref(x.double(), attn.double(), ff.double(), cos.double(),
                                         sin.double(), heads)
        attn, ff = attn.float(), ff.float()
        two = _block_emulated(x, attn, ff, cos, sin, heads, 2)
        one = _block_emulated(x, attn, ff, cos, sin, heads, 1)
        plain = fused_time_roformer_ref(x, attn, ff, cos, sin, heads)
        xb = x.bfloat16()
        bf = _block_emulated(xb, attn, ff, cos, sin, heads, 1).bfloat16()
        plain_bf = fused_time_roformer_ref(xb, attn, ff, cos, sin, heads)
    assert _rel(two, want64) < 1e-4
    assert _rel(one, want64) > 1e-3  # why float32 takes two parts
    assert _rel(two, plain) <= 1e-3
    assert _rel(bf, plain_bf) < 2.5e-2


@pytest.mark.parametrize("c,rows", [(64, 601), (128, 300)])
def test_eval_ff_split_products(c, rows):
    _, ff = _block(c, c // 32, rows)
    x = _x((rows, c), c)
    with torch.no_grad():
        want64 = fused_ff_ref(x.double(), ff.double())
        ff = ff.float()
        two = _ff_emulated(x, ff, torch.float32, 2)
        one = _ff_emulated(x, ff, torch.float32, 1)
        plain = fused_ff_ref(x, ff)
        xb = x.bfloat16()
        bf = _ff_emulated(xb.float(), ff, torch.bfloat16, 1).bfloat16()
        plain_bf = fused_ff_ref(xb, ff)
    assert _rel(two, want64) < 1e-4
    assert _rel(one, want64) > 1e-3
    assert _rel(two, plain) <= 1e-3
    assert _rel(bf, plain_bf) < 2.5e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_ff_is_the_training_forward_at_rate_0(dtype):
    """K1 and K2's tail run B8's launches with dropout off: on float32 rows
    the emulated tail is B8's plain branch (`ff_train_branch`, the rounding
    points of the compute dtype) at rate 0, in bfloat16 up to the order of
    float32 sums, in float32 up to the two-part split (~4e-6)."""
    c = 128
    _, ff = _block(c, c // 32, 5)
    y1 = _x((200, c), 6) * 3
    parts = 2 if dtype == torch.float32 else 1
    with torch.no_grad():
        got = _ff_emulated(y1, ff, dtype, parts)
        want = y1 + ff_train_branch(y1, ff, dtype, 0.0, None, drop.SALT_FF)
    assert _rel(got, want) < (1e-5 if dtype == torch.float32 else 1e-6)
