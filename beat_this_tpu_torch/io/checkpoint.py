"""Checkpoints for the PyTorch model: local loading, weights carried over from
the JAX package, and numpy-seeded initialization.

The state-dict key map is the JAX package's
(beat_this_tpu/io/torch_ckpt.py: `_strip_keys`, `pytree_to_torch_state_dict`),
which imports no JAX.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from beat_this_tpu.io.torch_ckpt import _strip_keys, pytree_to_torch_state_dict
from beat_this_tpu_torch.model.beat_this import BeatThisConfig


def load_checkpoint(checkpoint_path) -> dict:
    """Load a reference-format checkpoint dict from a local file. Released
    checkpoints are not fetched by shortname or URL."""
    if not os.path.isfile(checkpoint_path):
        raise ValueError(
            f"checkpoint {checkpoint_path!r} is not a local file (shortnames and "
            "URLs are not supported by this package)"
        )
    return torch.load(checkpoint_path, map_location="cpu", weights_only=True)


def model_state_dict(checkpoint: dict) -> dict[str, torch.Tensor]:
    """The model's state dict from a checkpoint: `model.` and `_orig_mod.`
    prefixes stripped, loss buffers, rotary tables and batch counters
    dropped."""
    return _strip_keys(checkpoint["state_dict"])


def _to_torch(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def from_jax(params: dict, state: dict) -> dict[str, torch.Tensor]:
    """State dict of the PyTorch model from the JAX package's (params, state)
    pytrees (JAX or numpy arrays)."""
    return _to_torch(_strip_keys(pytree_to_torch_state_dict(params, state)))


def init_beat_this(seed: int, config: BeatThisConfig = BeatThisConfig()) -> dict[str, torch.Tensor]:
    """State dict of a freshly initialized model, drawn from
    `numpy.random.default_rng(seed)` in the same order and with the same
    distributions as beat_this_tpu.model.init_beat_this (reference
    beat_this/model/beat_tracker.py:170-186), so both packages start from
    the same weights for the same seed."""
    c = config
    gen = np.random.default_rng(int(seed))
    f32 = np.float32

    def linear(fan_in, fan_out, bias=True):
        p = {"w": (0.02 * gen.standard_normal((fan_in, fan_out))).astype(f32)}
        if bias:
            p["b"] = np.zeros((fan_out,), f32)
        return p

    def conv(k_t, k_f, c_in, c_out):
        std = float(np.sqrt(2.0 / (c_out * k_t * k_f)))
        return {"w": (std * gen.standard_normal((k_t, k_f, c_in, c_out))).astype(f32)}

    def attention(dim, heads):
        inner = heads * c.head_dim
        return {
            "norm_gamma": np.ones((dim,), f32),
            "qkv_w": (0.02 * gen.standard_normal((dim, 3 * inner))).astype(f32),
            "gates_w": (0.02 * gen.standard_normal((dim, heads))).astype(f32),
            "gates_b": np.zeros((heads,), f32),
            "out_w": (0.02 * gen.standard_normal((inner, dim))).astype(f32),
        }

    def ff(dim, mult):
        return {
            "norm_gamma": np.ones((dim,), f32),
            "w1": (0.02 * gen.standard_normal((dim, dim * mult))).astype(f32),
            "b1": np.zeros((dim * mult,), f32),
            "w2": (0.02 * gen.standard_normal((dim * mult, dim))).astype(f32),
            "b2": np.zeros((dim,), f32),
        }

    def bn(dim):
        return (
            {"gamma": np.ones((dim,), f32), "beta": np.zeros((dim,), f32)},
            {"mean": np.zeros((dim,), f32), "var": np.ones((dim,), f32)},
        )

    params: dict[str, Any] = {}
    state: dict[str, Any] = {}
    bn1d_p, bn1d_s = bn(c.spect_dim)
    bn2d_p, bn2d_s = bn(c.stem_dim)
    params["stem"] = {"bn1d": bn1d_p, "conv": conv(3, 4, 1, c.stem_dim), "bn2d": bn2d_p}
    state["stem"] = {"bn1d": bn1d_s, "bn2d": bn2d_s}
    params["blocks"], state["blocks"] = [], []
    for dim in c.frontend_dims:
        heads = dim // c.head_dim
        block: dict[str, Any] = {}
        if c.partial_transformers:
            block["partial"] = {
                "attnF": attention(dim, heads),
                "ffF": ff(dim, 4),
                "attnT": attention(dim, heads),
                "ffT": ff(dim, 4),
            }
        block["conv"] = conv(3, 2, dim, dim * 2)
        block["bn"], bn_s = bn(dim * 2)
        params["blocks"].append(block)
        state["blocks"].append({"bn": bn_s})
    params["linear"] = linear(c.stem_dim * 8 * (c.spect_dim // 32), c.transformer_dim)
    heads = c.transformer_dim // c.head_dim
    params["transformer"] = {
        "layers": [
            {"attn": attention(c.transformer_dim, heads), "ff": ff(c.transformer_dim, c.ff_mult)}
            for _ in range(c.n_layers)
        ],
        "norm_gamma": np.ones((c.transformer_dim,), f32),
    }
    params["head"] = linear(c.transformer_dim, 2)
    return _to_torch(_strip_keys(pytree_to_torch_state_dict(params, state)))
