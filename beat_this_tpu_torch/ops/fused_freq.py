"""Fused frequency-axis roformer block (eval): `x + attention(x)`, then the
feed-forward residual, over (items, F, C) with attention across the F bins
of each item.

Counterpart of beat_this_tpu/ops/fused_freq.py:fused_freq_roformer at
dropout rate 0. On a CUDA tensor `fused_freq_roformer` launches the
hand-written kernel in `csrc/fused_freq.cu`; on a CPU tensor it runs the
plain version `fused_freq_roformer_ref`, the composable path.
"""

from __future__ import annotations

import torch

from beat_this_tpu_torch.model.layers import (
    HEAD_DIM,
    Attention,
    FeedForward,
    attention_block,
    feed_forward,
)
from beat_this_tpu_torch.ops import _build
from beat_this_tpu_torch.ops.fused_ff import dtype_code, f32, stream_of
from beat_this_tpu_torch.ops.fused_time import block_params

SUPPORTED_DIMS = (32, 64, 128)


def fused_freq_roformer_ref(x, attn: Attention, ff: FeedForward, rope_cos,
                            rope_sin) -> torch.Tensor:
    """Plain PyTorch version: `x + attention_block`, then `+ feed_forward`."""
    heads = x.shape[-1] // HEAD_DIM
    y = x + attention_block(attn, x, (rope_cos, rope_sin), heads)
    return y + feed_forward(ff, y)


def fused_freq_roformer(x: torch.Tensor, attn: Attention, ff: FeedForward,
                        rope_cos: torch.Tensor, rope_sin: torch.Tensor) -> torch.Tensor:
    """One frequency-axis roformer block over (items, F, C) with C // 32
    heads. rope_cos/rope_sin: (>= F, 16) tables. CUDA tensors run the kernel
    (F dividing 32, C in SUPPORTED_DIMS, float32 or bfloat16); CPU tensors
    the plain version."""
    if x.device.type == "cpu":
        return fused_freq_roformer_ref(x, attn, ff, rope_cos, rope_sin)
    if x.device.type != "cuda":
        raise ValueError(f"fused_freq_roformer runs on CUDA or CPU tensors, got {x.device}")
    items, f, c = x.shape
    if c not in SUPPORTED_DIMS or 32 % f:
        raise ValueError(
            f"fused_freq kernel needs C in {SUPPORTED_DIMS} and F dividing 32, "
            f"got C={c}, F={f}"
        )
    code = dtype_code(x.dtype)
    lib = _build.load_library()
    xc = x.contiguous()
    params = block_params(attn, ff, x.dtype)
    cos, sin = f32(rope_cos[:f]), f32(rope_sin[:f])
    out = torch.empty_like(xc)
    with torch.cuda.device(x.device):
        _build.check(
            lib.bt_fused_freq(
                code, c, xc.data_ptr(), *(p.data_ptr() for p in params),
                cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
                items * f, f, ff.net[1].out_features, stream_of(x),
            ),
            "bt_fused_freq",
        )
    fused_freq_roformer.launches += 1
    return out


fused_freq_roformer.launches = 0
