"""Rotary position embeddings (RoPE), interleaved-pair convention.

Counterpart of beat_this_tpu/ops/rotary.py: theta 10000, rotation over the
whole head dimension, each pair (2i, 2i+1) sharing the angle
t * theta^(-2i/d):

    out[2i]   = x[2i] * cos - x[2i+1] * sin
    out[2i+1] = x[2i+1] * cos + x[2i]  * sin
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _tables_np(seq_len: int, head_dim: int, theta: float):
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    angles = np.outer(np.arange(seq_len, dtype=np.float64), inv_freq)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def rope_tables(seq_len: int, head_dim: int, device="cpu", theta: float = 10000.0):
    """(cos, sin) tables of shape (seq_len, head_dim // 2), float32, computed in
    float64 on the host."""
    if head_dim % 2 != 0:
        raise ValueError(f"head_dim must be even, got {head_dim}")
    cos, sin = _tables_np(int(seq_len), int(head_dim), float(theta))
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate `x` of shape (..., seq_len, head_dim) by half-width tables
    (seq_len, head_dim // 2), computing in the dtype of `x`."""
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    x_even = x[..., 0::2]
    x_odd = x[..., 1::2]
    out_even = x_even * cos - x_odd * sin
    out_odd = x_odd * cos + x_even * sin
    return torch.stack([out_even, out_odd], dim=-1).reshape(x.shape)
