"""Peak picking for the minimal postprocessor, counterpart of
beat_this_tpu/ops/pool.py:peak_pick."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def peak_pick(logits: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
    """Strict local maxima over the last axis: padding is forced to -1000,
    and a frame is a peak iff it equals the max over a +/-3 frame window
    (70 ms) and its logit is > 0 (reference
    beat_this/model/postprocessor.py:90-99). (..., T) -> (..., T) bool."""
    x = logits.float().masked_fill(~valid_mask, -1000.0)
    shape = x.shape
    pooled = F.max_pool1d(x.reshape(-1, 1, shape[-1]), 7, stride=1, padding=3).reshape(shape)
    return (x == pooled) & (x > 0)
