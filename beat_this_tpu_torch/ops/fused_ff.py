"""Fused feed-forward residual `x + W2 gelu(W1 rmsnorm(x) + b1) + b2`.

Counterpart of beat_this_tpu/ops/fused_ff.py:fused_ff. On a CUDA tensor
`fused_ff` launches the hand-written kernel in `csrc/fused_ff.cu`; on a CPU
tensor it runs the plain version `fused_ff_ref`, the composable path.
"""

from __future__ import annotations

import torch

from beat_this_tpu_torch.model.layers import FeedForward, feed_forward
from beat_this_tpu_torch.ops import _build

SUPPORTED_DIMS = (32, 64, 128, 512)


def dtype_code(dtype: torch.dtype) -> int:
    """The C entry points' dtype argument: 0 float32, 1 bfloat16."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise ValueError(f"the kernels take float32 or bfloat16, got {dtype}")


def kernel_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight as the kernels read it: contiguous, in the compute dtype."""
    return w.detach().to(dtype).contiguous()


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def ff_params(ff: FeedForward, dtype: torch.dtype) -> list[torch.Tensor]:
    """The feed-forward's parameters as the C entry points take them, in
    their order (gamma, w1, b1, w2, b2): weights in the compute dtype, the
    norm gain and biases in float32, as the TPU kernels hold them."""
    norm, lin1, _, _, lin2, _ = ff.net
    return [f32(norm.gamma), kernel_weight(lin1.weight, dtype), f32(lin1.bias),
            kernel_weight(lin2.weight, dtype), f32(lin2.bias)]


def fused_ff_ref(x: torch.Tensor, ff: FeedForward) -> torch.Tensor:
    """Plain PyTorch version: `x + feed_forward(ff, x)`."""
    return x + feed_forward(ff, x)


def fused_ff(x: torch.Tensor, ff: FeedForward) -> torch.Tensor:
    """x: (..., C) -> x + FF(x). CUDA tensors run the fused kernel (C in
    SUPPORTED_DIMS, float32 or bfloat16); CPU tensors the plain version."""
    if x.device.type == "cpu":
        return fused_ff_ref(x, ff)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ff runs on CUDA or CPU tensors, got {x.device}")
    c = x.shape[-1]
    if c not in SUPPORTED_DIMS:
        raise ValueError(f"fused_ff kernel supports C in {SUPPORTED_DIMS}, got {c}")
    code = dtype_code(x.dtype)
    lib = _build.load_library()
    xc = x.contiguous()
    out = torch.empty_like(xc)
    params = ff_params(ff, x.dtype)
    with torch.cuda.device(x.device):
        _build.check(
            lib.bt_fused_ff(
                code, c, xc.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(),
                xc.numel() // c, ff.net[1].out_features, stream_of(x),
            ),
            "bt_fused_ff",
        )
    fused_ff.launches += 1
    return out


fused_ff.launches = 0
