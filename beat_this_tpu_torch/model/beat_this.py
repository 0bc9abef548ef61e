"""The BeatThis model (eval) as a PyTorch module, counterpart of
beat_this_tpu/model/beat_this.py.

The module tree and parameter names are the reference's
(beat_this/model/beat_tracker.py), so `state_dict()` keys match a released
checkpoint's after its `model.` prefix is stripped. The forward keeps the
JAX package's (batch, time, freq, channels) activation layout and its
routing: frequency blocks through `freq_roformer`, unmasked time blocks and
main layers through `time_roformer`, and with `valid_lengths` the masked
composable attention plus `ff_residual`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from beat_this_tpu_torch.model.layers import (
    Attention,
    BatchNorm,
    FeedForward,
    RMSNorm,
    attention_block,
    batch_norm_apply,
    conv2d_tf,
    ff_residual,
    freq_roformer,
    rms_norm,
    time_roformer,
)
from beat_this_tpu_torch.ops.rotary import rope_tables


@dataclass(frozen=True)
class BeatThisConfig:
    """Hyperparameters, defaults as the reference
    (beat_this/model/beat_tracker.py:38-49)."""

    spect_dim: int = 128
    transformer_dim: int = 512
    ff_mult: int = 4
    n_layers: int = 6
    head_dim: int = 32
    stem_dim: int = 32
    dropout_frontend: float = 0.1
    dropout_transformer: float = 0.2
    sum_head: bool = True
    partial_transformers: bool = True

    @classmethod
    def from_hparams(cls, hparams: dict) -> "BeatThisConfig":
        """Build from a checkpoint's `hyper_parameters`, keeping only the keys
        the model understands."""
        kwargs: dict[str, Any] = {}
        for key in (
            "spect_dim", "transformer_dim", "ff_mult", "n_layers", "head_dim",
            "stem_dim", "sum_head", "partial_transformers",
        ):
            if key in hparams:
                kwargs[key] = hparams[key]
        dropout = hparams.get("dropout")
        if isinstance(dropout, dict):
            kwargs["dropout_frontend"] = dropout.get("frontend", 0.1)
            kwargs["dropout_transformer"] = dropout.get("transformer", 0.2)
        return cls(**kwargs)

    @property
    def frontend_dims(self) -> list[int]:
        return [self.stem_dim * (2**i) for i in range(3)]  # 32, 64, 128


class _Stem(nn.Module):
    def __init__(self, c: BeatThisConfig):
        super().__init__()
        self.bn1d = BatchNorm(c.spect_dim)
        self.conv2d = nn.Conv2d(1, c.stem_dim, (4, 3), stride=(4, 1), padding=(0, 1),
                                bias=False)
        self.bn2d = BatchNorm(c.stem_dim)


class _Partial(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.attnF = Attention(dim, heads, head_dim)
        self.ffF = FeedForward(dim)
        self.attnT = Attention(dim, heads, head_dim)
        self.ffT = FeedForward(dim)


class _FrontendBlock(nn.Module):
    def __init__(self, dim: int, c: BeatThisConfig):
        super().__init__()
        if c.partial_transformers:
            self.partial = _Partial(dim, dim // c.head_dim, c.head_dim)
        self.conv2d = nn.Conv2d(dim, dim * 2, (2, 3), stride=(2, 1), padding=(0, 1),
                                bias=False)
        self.norm = BatchNorm(dim * 2)


class _Frontend(nn.Module):
    def __init__(self, c: BeatThisConfig):
        super().__init__()
        self.stem = _Stem(c)
        self.blocks = nn.ModuleList(_FrontendBlock(d, c) for d in c.frontend_dims)
        concat_dim = c.stem_dim * 8 * (c.spect_dim // 32)  # 256 * 4 = 1024
        self.linear = nn.Linear(concat_dim, c.transformer_dim)


class _Transformer(nn.Module):
    def __init__(self, c: BeatThisConfig):
        super().__init__()
        heads = c.transformer_dim // c.head_dim
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Attention(c.transformer_dim, heads, c.head_dim),
                FeedForward(c.transformer_dim, c.ff_mult),
            ])
            for _ in range(c.n_layers)
        )
        self.norm = RMSNorm(c.transformer_dim)


class _TaskHeads(nn.Module):
    def __init__(self, c: BeatThisConfig):
        super().__init__()
        self.beat_downbeat_lin = nn.Linear(c.transformer_dim, 2)


class BeatThis(nn.Module):
    """Frontend (stem, three partial-transformer blocks, projection), main
    transformer and SumHead, under the reference's parameter names."""

    def __init__(self, config: BeatThisConfig = BeatThisConfig()):
        super().__init__()
        self.config = config
        self.frontend = _Frontend(config)
        self.transformer_blocks = _Transformer(config)
        self.task_heads = _TaskHeads(config)

    def forward(
        self,
        x: torch.Tensor,
        valid_lengths: Optional[torch.Tensor] = None,
        compute_dtype: torch.dtype = torch.float32,
        kernels: bool = True,
    ) -> dict[str, torch.Tensor]:
        """x: (batch, time, spect_dim) log-mel -> {"beat", "downbeat"} float32
        logits of shape (batch, time).

        `valid_lengths` (batch,) int: each sample's output equals a run on
        only its first `valid_lengths[i]` frames (the tail is re-zeroed
        before every time convolution and masked out of attention).
        `compute_dtype`: torch.float32 or torch.bfloat16 for the heavy
        compute; norms, softmax and the head stay float32. `kernels=False`
        takes the composable path everywhere (the kernels' plain versions).
        """
        h = self.features(x, valid_lengths, compute_dtype, kernels)
        head = self.task_heads.beat_downbeat_lin
        y = F.linear(h, head.weight.float(), head.bias.float())
        beat, downbeat = y[..., 0], y[..., 1]
        if self.config.sum_head:
            beat = beat + downbeat
        return {"beat": beat, "downbeat": downbeat}

    def features(
        self,
        x: torch.Tensor,
        valid_lengths: Optional[torch.Tensor] = None,
        compute_dtype: torch.dtype = torch.float32,
        kernels: bool = True,
    ) -> torch.Tensor:
        """The final RMS-normed embedding (batch, time, transformer_dim) that
        the head reads, as float32; arguments as `forward`."""
        c = self.config
        b, t, f = x.shape
        if f != c.spect_dim:
            raise ValueError(f"expected {c.spect_dim} mel bins, got {f}")
        tmask = None
        if valid_lengths is not None:
            tmask = (
                torch.arange(t, device=x.device)[None, :]
                < valid_lengths.to(x.device)[:, None]
            )

        def zero_tail(h):
            if tmask is None:
                return h
            mask = tmask.reshape(tmask.shape + (1,) * (h.ndim - 2))
            return torch.where(mask, h, torch.zeros((), dtype=h.dtype, device=h.device))

        stem = self.frontend.stem
        h = batch_norm_apply(stem.bn1d, x)
        h = zero_tail(h.to(compute_dtype))[..., None]  # (B, T, F, 1)
        h = conv2d_tf(stem.conv2d.weight, h, stride_freq=4, pad_time=1)
        h = F.gelu(batch_norm_apply(stem.bn2d, h))  # (B, T, 32, 32)

        rope_time = rope_tables(t, c.head_dim, x.device)
        for block in self.frontend.blocks:
            dim = h.shape[-1]
            heads = dim // c.head_dim
            n_freq = h.shape[2]
            if c.partial_transformers:
                p = block.partial
                rope_freq = rope_tables(n_freq, c.head_dim, x.device)
                hf = h.reshape(b * t, n_freq, dim)
                hf = freq_roformer(p.attnF, p.ffF, hf, rope_freq, heads, kernels=kernels)
                ht = hf.reshape(b, t, n_freq, dim).transpose(1, 2).reshape(b * n_freq, t, dim)
                if tmask is None:
                    ht = time_roformer(p.attnT, p.ffT, ht, rope_time, heads, kernels=kernels)
                else:
                    ht = ht + attention_block(
                        p.attnT, ht, rope_time, heads,
                        key_mask=tmask.repeat_interleave(n_freq, dim=0),
                    )
                    ht = ff_residual(p.ffT, ht, kernels=kernels)
                h = ht.reshape(b, n_freq, t, dim).transpose(1, 2)
            h = zero_tail(h)
            h = conv2d_tf(block.conv2d.weight, h, stride_freq=2, pad_time=1)
            h = F.gelu(batch_norm_apply(block.norm, h))

        # (B, T, F=4, C=256) -> (B, T, (C, F)): the reference concatenates in
        # (channel, freq) order
        h = h.transpose(2, 3).reshape(b, t, -1)
        lin = self.frontend.linear
        h = F.linear(h, lin.weight.to(h.dtype), lin.bias.to(h.dtype))

        heads = c.transformer_dim // c.head_dim
        for attn, ff in self.transformer_blocks.layers:
            if tmask is None:
                h = time_roformer(attn, ff, h, rope_time, heads, kernels=kernels)
            else:
                h = h + attention_block(attn, h, rope_time, heads, key_mask=tmask)
                h = ff_residual(ff, h, kernels=kernels)
        return rms_norm(h, self.transformer_blocks.norm.gamma).float()
