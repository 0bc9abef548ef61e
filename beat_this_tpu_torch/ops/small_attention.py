"""Exact-softmax attention over (items, F, head_dim) for very short
sequences: the frontend's frequency axis (F 32 / 16 / 8 bins) with the
heads folded into the items, thousands of independent F x F problems.

Counterpart of beat_this_tpu/ops/small_attention.py:small_attention, which
`attention_block` takes for unmasked sequences whose length divides 128 and
is at most 32 when the fused frequency kernel declines the shape (a head
width other than 32). On a CUDA tensor `small_attention` launches the
hand-written kernels in `csrc/small_attention.cu` (every product on the
tensor cores over block-diagonal score tiles of 16 or 32 keys, float32 as
split bf16 products; F any divisor of 32); on a CPU tensor it runs the
plain version `small_attention_ref`. Differentiable: the backward kernel
recomputes the softmax from q, k, v.

The rotation of q and k, the dropout of the probabilities (SALT_ATTN,
SITE_ATTN_PROBS, coordinates (item // heads, item % heads, query, key)) and
the bfloat16 rounding points are those of `ops/flash_attention.py`.
"""

from __future__ import annotations

from typing import Optional

import torch

from beat_this_tpu_torch.model.layers import round_grad, round_value, wide
from beat_this_tpu_torch.ops import _build
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops import flash_attention as flash
from beat_this_tpu_torch.ops.fused_ff import stream_of
from beat_this_tpu_torch.profiler import op_entry

SUPPORTED_SEQ = (1, 2, 4, 8, 16, 32)
# bfloat16 parts of a float32 operand in the kernels' forward and backward,
# and of dv's operands in either dtype (tests/test_torch_small_tc_design.py)
FWD_PARTS, BWD_PARTS, DV_PARTS = 3, 2, 3


def small_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rope_cos: Optional[torch.Tensor] = None,
                        rope_sin: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
                        seed: Optional[int] = None, heads: int = 1,
                        item0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of `small_attention`, step by step with the
    kernels' rounding points, differentiable by autograd. Items are
    independent, so nothing is packed or masked."""
    dtype = q.dtype
    items, f, d = q.shape
    qr = flash.rotated(q, rope_cos, rope_sin, d**-0.5 * flash.LOG2E)
    kr = flash.rotated(k, rope_cos, rope_sin)
    s = round_grad(torch.matmul(qr, kr.transpose(-1, -2)), dtype)
    p = torch.exp2(s - s.amax(-1, keepdim=True).detach())
    norm = p.sum(-1, keepdim=True)
    if dropout_rate > 0.0 and seed is not None:
        with torch.no_grad():
            keep = flash.probs_keep(seed, item0 * heads, items, heads, f, f, dropout_rate,
                                    q.device)
        p = p * keep.to(p.dtype)
    return (torch.matmul(round_value(p, dtype), wide(v)) / norm).to(dtype)


def _check(q, k, v, cos, sin) -> int:
    """`flash_attention`'s checks plus the sequence length; returns the
    dtype code."""
    code = flash.check_qkv("small_attention", q, k, v, cos, sin)
    if q.shape[1] not in SUPPORTED_SEQ:
        raise ValueError(f"small_attention kernel supports sequence lengths {SUPPORTED_SEQ}, "
                         f"got {q.shape[1]}")
    return code


@op_entry
def small_fwd(q, k, v, cos, sin, rate, seed, heads, item0: int = 0) -> torch.Tensor:
    """Launch the forward on q, k, v (items, F, D); returns o."""
    code = _check(q, k, v, cos, sin)
    items, f, d = q.shape
    lib = _build.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.check(
            lib.bt_small_attn_fwd(
                code, f, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), flash.ptr(cos),
                flash.ptr(sin), out.data_ptr(), items, heads,
                *drop.kernel_args(rate, seed, drop.SALT_ATTN), *drop.base_args(item0, 0),
                stream_of(q),
            ),
            "bt_small_attn_fwd",
        )
    small_fwd.launches += 1
    return out


@op_entry
def small_bwd(q, k, v, cos, sin, dout, rate, seed, heads, item0: int = 0):
    """Launch the backward; returns (dq, dk, dv)."""
    code = _check(q, k, v, cos, sin)
    items, f, d = q.shape
    lib = _build.load_library()
    dout = flash.aligned(dout.to(q.dtype))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        _build.check(
            lib.bt_small_attn_bwd(
                code, f, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), flash.ptr(cos),
                flash.ptr(sin), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                items, heads, *drop.kernel_args(rate, seed, drop.SALT_ATTN),
                *drop.base_args(item0, 0), stream_of(q),
            ),
            "bt_small_attn_bwd",
        )
    small_bwd.launches += 1
    return dq, dk, dv


small_fwd.launches = 0
small_bwd.launches = 0


class _SmallAttention(torch.autograd.Function):
    """q, k, v (items, F, D) -> o; saves only the inputs, the backward
    recomputes the softmax and regenerates the dropout mask from `seed`."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, rate, seed, heads, item0):
        ctx.rate, ctx.seed, ctx.heads, ctx.item0 = rate, seed, heads, item0
        ctx.save_for_backward(q, k, v, cos, sin)
        return small_fwd(q, k, v, cos, sin, rate, seed, heads, item0)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, cos, sin = ctx.saved_tensors
        dq, dk, dv = small_bwd(q, k, v, cos, sin, dout, ctx.rate, ctx.seed, ctx.heads,
                               ctx.item0)
        return dq, dk, dv, None, None, None, None, None, None


def small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rope_cos: Optional[torch.Tensor] = None,
                    rope_sin: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
                    seed: Optional[int] = None, heads: int = 1,
                    item0: int = 0) -> torch.Tensor:
    """Differentiable attention over q, k, v (items, F, head_dim) with scale
    head_dim^-0.5, optional half-width rotation tables (F, head_dim // 2)
    applied to q and k inside, and dropout on the probabilities at
    `dropout_rate` from the int `seed` (off when None), item e drawing the
    mask of (item0 + e // heads, e % heads). CUDA tensors run the kernels (F in
    SUPPORTED_SEQ, head_dim in flash_attention.SUPPORTED_HEAD_DIMS, float32
    or bfloat16) or raise; CPU tensors the plain version."""
    if q.device.type == "cpu":
        return small_attention_ref(q, k, v, rope_cos, rope_sin, dropout_rate, seed, heads,
                                   item0)
    f = q.shape[1]
    return _SmallAttention.apply(flash.aligned(q), flash.aligned(k), flash.aligned(v),
                                 flash.table(rope_cos, f), flash.table(rope_sin, f),
                                 float(dropout_rate), seed, int(heads), int(item0))
