"""Fused time-axis roformer block (eval): `x + attention(x)`, then the
feed-forward residual, over (items, n, C).

Counterpart of beat_this_tpu/ops/fused_time.py:fused_time_roformer. On a
CUDA tensor `fused_time_roformer` launches the hand-written kernels in
`csrc/fused_time.cu` (norm + q/k/v + RoPE + gates, flash attention + gate,
out projection + residual + feed-forward); on a CPU tensor it runs the plain
version `fused_time_roformer_ref`, the composable path.
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
from beat_this_tpu_torch.ops.fused_ff import (
    SUPPORTED_DIMS,
    dtype_code,
    f32,
    ff_params,
    kernel_weight,
    stream_of,
)


def block_params(attn: Attention, ff: FeedForward, dtype: torch.dtype) -> list[torch.Tensor]:
    """A roformer block's parameters as the C entry points take them, in
    their order (agamma, wqkv, wg, gb, wout, then `ff_params`): projection
    weights in the compute dtype, norm gains and the gate in float32."""
    return [
        f32(attn.norm.gamma), kernel_weight(attn.to_qkv.weight, dtype),
        f32(attn.to_gates.weight), f32(attn.to_gates.bias),
        kernel_weight(attn.to_out[0].weight, dtype),
    ] + ff_params(ff, dtype)


def fused_time_roformer_ref(x, attn: Attention, ff: FeedForward, rope_cos, rope_sin,
                            heads: int) -> torch.Tensor:
    """Plain PyTorch version: `x + attention_block`, then `+ feed_forward`."""
    y = x + attention_block(attn, x, (rope_cos, rope_sin), heads)
    return y + feed_forward(ff, y)


def fused_time_roformer(x: torch.Tensor, attn: Attention, ff: FeedForward,
                        rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """One whole pre-norm roformer block over (items, n, C), C == heads * 32.
    rope_cos/rope_sin: (>= n, 16) tables. CUDA tensors run the kernels (C in
    SUPPORTED_DIMS, float32 or bfloat16); CPU tensors the plain version."""
    if x.device.type == "cpu":
        return fused_time_roformer_ref(x, attn, ff, rope_cos, rope_sin, heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_time_roformer runs on CUDA or CPU tensors, got {x.device}")
    items, n, c = x.shape
    if c != heads * HEAD_DIM or c not in SUPPORTED_DIMS:
        raise ValueError(
            f"fused_time kernel needs C == heads * {HEAD_DIM} in {SUPPORTED_DIMS}, "
            f"got C={c}, heads={heads}"
        )
    dtype = x.dtype
    code = dtype_code(dtype)
    lib = _build.load_library()
    xc = x.contiguous()
    params = block_params(attn, ff, dtype)
    cos, sin = f32(rope_cos[:n]), f32(rope_sin[:n])
    q, k, v = (
        torch.empty((items, heads, n, HEAD_DIM), dtype=dtype, device=x.device)
        for _ in range(3)
    )
    gates = torch.empty((items * n, heads), dtype=torch.float32, device=x.device)
    attn_out = torch.empty_like(xc)
    out = torch.empty_like(xc)
    with torch.cuda.device(x.device):
        _build.check(
            lib.bt_fused_time(
                code, c, xc.data_ptr(), *(p.data_ptr() for p in params),
                cos.data_ptr(), sin.data_ptr(), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), gates.data_ptr(), attn_out.data_ptr(), out.data_ptr(),
                items, n, ff.net[1].out_features, stream_of(x),
            ),
            "bt_fused_time",
        )
    fused_time_roformer.launches += 1
    return out


fused_time_roformer.launches = 0
