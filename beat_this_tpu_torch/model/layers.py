"""Building blocks of the BeatThis model (eval), PyTorch counterpart of
beat_this_tpu/model/layers.py.

Modules hold the parameters under the reference's names
(beat_this/model/roformer.py): `RMSNorm.gamma`; `Attention.norm`, `.to_qkv`,
`.to_gates`, `.to_out.0`; `FeedForward.net.{0,1,4}`. Weights keep torch's
Linear layout (out_features, in_features), and conv weights the reference's
OIHW layout with H = frequency and W = time.

The functions keep the JAX package's activation layout: sequences are
(items, seq, C) and frontend activations (batch, time, freq, C). The
routers `ff_residual`, `freq_roformer` and `time_roformer` take the fused
kernels under the same conditions as the JAX routers, and otherwise (or
with `kernels=False`) the composable path, which is also what the kernels'
plain versions compute.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from beat_this_tpu_torch.ops.rotary import apply_rope

BN_EPS = 1e-5
# time-axis sequences at least this long take the fused time kernel
FLASH_MIN_SEQ = 512
HEAD_DIM = 32


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Attention(nn.Module):
    """Pre-norm gated rotary attention (reference roformer.Attention)."""

    def __init__(self, dim: int, heads: int, head_dim: int = HEAD_DIM):
        super().__init__()
        inner = heads * head_dim
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_gates = nn.Linear(dim, heads)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, bias=False))


class FeedForward(nn.Module):
    """Pre-norm MLP with exact GELU (reference roformer.FeedForward); the
    parameter-free entries keep the reference's Sequential indices."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(
            RMSNorm(dim),
            nn.Linear(dim, dim * mult),
            nn.GELU(),
            nn.Identity(),
            nn.Linear(dim * mult, dim),
            nn.Identity(),
        )


class BatchNorm(nn.Module):
    """Batch-norm parameters and running statistics under torch's names
    (weight, bias, running_mean, running_var), applied in eval mode only."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """`F.normalize(x, dim=-1) * sqrt(dim) * gamma`, computed in float32 and
    returned in the dtype of `x`."""
    dim = x.shape[-1]
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True))
    out = x32 / torch.clamp_min(norm, 1e-12) * (dim**0.5) * gamma.float()
    return out.to(x.dtype)


def sdpa(q, k, v, *, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention over (..., heads, seq, head_dim): scale
    head_dim^-0.5, float32 scores and softmax. `key_mask` (batch, seq) bool:
    False keys get probability zero."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)


def attention_block(
    attn: Attention,
    x: torch.Tensor,
    rope: tuple[torch.Tensor, torch.Tensor],
    heads: int,
    *,
    key_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The attention residual branch on (b, n, C) (the caller adds x)."""
    b, n, _ = x.shape
    g = rms_norm(x, attn.norm.gamma)
    qkv = F.linear(g, attn.to_qkv.weight.to(g.dtype))
    inner = qkv.shape[-1] // 3
    # torch layout "(qkv h d)": qkv slowest, then head, then head_dim
    qkv = qkv.reshape(b, n, 3, heads, inner // heads).permute(2, 0, 3, 1, 4)
    cos, sin = rope
    q = apply_rope(qkv[0], cos, sin)
    k = apply_rope(qkv[1], cos, sin)
    out = sdpa(q, k, qkv[2], key_mask=key_mask)  # (b, heads, n, head_dim)
    gates = F.linear(
        g, attn.to_gates.weight.to(g.dtype), attn.to_gates.bias.to(g.dtype)
    )
    out = out * torch.sigmoid(gates.transpose(1, 2))[..., None]
    out = out.transpose(1, 2).reshape(b, n, inner)
    return F.linear(out, attn.to_out[0].weight.to(out.dtype))


def feed_forward(ff: FeedForward, x: torch.Tensor) -> torch.Tensor:
    """The feed-forward residual branch (the caller adds x)."""
    norm, lin1, _, _, lin2, _ = ff.net
    g = rms_norm(x, norm.gamma)
    h = F.gelu(F.linear(g, lin1.weight.to(g.dtype), lin1.bias.to(g.dtype)))
    return F.linear(h, lin2.weight.to(h.dtype), lin2.bias.to(h.dtype))


def ff_residual(ff: FeedForward, x: torch.Tensor, *, kernels: bool = True):
    """`x + feed_forward(x)`; the fused_ff kernel when `kernels`."""
    if kernels:
        from beat_this_tpu_torch.ops.fused_ff import fused_ff

        return fused_ff(x, ff)
    return x + feed_forward(ff, x)


def freq_roformer(attn, ff, x, rope, heads, *, kernels: bool = True):
    """One frequency-axis roformer block on (items, F, C):
    `x + attention; + feed_forward`, as one fused kernel when `kernels`, F
    divides 128 (at most 32) and C == heads * 32 (the JAX router's
    conditions)."""
    f = x.shape[1]
    if kernels and f <= 32 and 128 % f == 0 and x.shape[-1] == heads * HEAD_DIM:
        from beat_this_tpu_torch.ops.fused_freq import fused_freq_roformer

        return fused_freq_roformer(x, attn, ff, rope[0], rope[1])
    x = x + attention_block(attn, x, rope, heads)
    return ff_residual(ff, x, kernels=kernels)


def time_roformer(attn, ff, x, rope, heads, *, kernels: bool = True):
    """One time-axis roformer block on (items, T, C) at eval:
    `x + attention; + feed_forward`, as the fused time kernel when `kernels`,
    T >= FLASH_MIN_SEQ, C == heads * 32 and heads is 1, 2 or a multiple of 4
    (the JAX router's conditions)."""
    if (
        kernels
        and x.shape[1] >= FLASH_MIN_SEQ
        and x.shape[-1] == heads * HEAD_DIM
        and (heads <= 2 or heads % 4 == 0)
    ):
        from beat_this_tpu_torch.ops.fused_time import fused_time_roformer

        return fused_time_roformer(x, attn, ff, rope[0], rope[1], heads)
    x = x + attention_block(attn, x, rope, heads)
    return ff_residual(ff, x, kernels=kernels)


def batch_norm_apply(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Eval batch norm over the last axis, folded into one scale and shift
    in float32; returns the dtype of `x`."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
    shift = bn.bias.float() - bn.running_mean.float() * scale
    return (x.float() * scale + shift).to(x.dtype)


def conv2d_tf(w: torch.Tensor, x: torch.Tensor, *, stride_freq: int, pad_time: int):
    """2-D convolution over (batch, time, freq, C), no bias. `w` is the
    reference's (out, in, k_freq, k_time) weight; stride 1 over time (zero
    padded by `pad_time` on both sides) and `stride_freq` over frequency
    (no padding), as the reference's Conv2d(kernel=(freq_k, 3),
    stride=(freq_s, 1), padding=(0, 1))."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2),  # (batch, C, time, freq)
        w.permute(0, 1, 3, 2).to(x.dtype),  # (out, in, k_time, k_freq)
        stride=(1, stride_freq),
        padding=(pad_time, 0),
    )
    return y.permute(0, 2, 3, 1)
