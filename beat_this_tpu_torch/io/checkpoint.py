"""Checkpoints for the PyTorch model: loading by local path, URL or released
shortname, weights carried over from the JAX package, and numpy-seeded
initialization.

The state-dict key map is `io/keys.py`, the port's copy of the JAX
package's (beat_this_tpu/io/torch_ckpt.py: `_strip_keys`,
`pytree_to_torch_state_dict`, `torch_state_dict_to_pytree`).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from beat_this_tpu_torch.io.keys import (
    _strip_keys,
    pytree_to_torch_state_dict,
    torch_state_dict_to_pytree,
)
from beat_this_tpu_torch.model.beat_this import BeatThisConfig


# where released checkpoints are published (the JAX package's CHECKPOINT_URL)
CHECKPOINT_URL = "https://cloud.cp.jku.at/public.php/dav/files/7ik4RrBKTS273gp"


def cache_dir() -> Path:
    """Where downloaded checkpoints are kept: $BEAT_THIS_CACHE, else
    ~/.cache/beat_this_tpu_torch."""
    return Path(os.environ.get("BEAT_THIS_CACHE", Path.home() / ".cache" / "beat_this_tpu_torch"))


def load_checkpoint(checkpoint_path) -> dict:
    """Load a reference-format checkpoint dict from a local path, a URL or a
    released shortname, in the reference's order (beat_this/inference.py:
    16-53): an existing file loads as it is; an http(s) URL downloads to
    <cache>/<basename>; any other name is fetched from CHECKPOINT_URL as
    <name>.ckpt and cached as beat_this-<name>.ckpt. A download is staged
    through a .tmp file and renamed; a failed one raises ValueError and
    caches nothing."""
    path = Path(checkpoint_path)
    if path.exists():
        return torch.load(path, map_location="cpu", weights_only=True)
    name = str(checkpoint_path)
    if name.startswith(("http://", "https://")):
        url, file_name = name, Path(name).name
    else:
        url, file_name = f"{CHECKPOINT_URL}/{name}.ckpt", f"beat_this-{name}.ckpt"
    cached = cache_dir() / file_name
    if not cached.exists():
        import urllib.request

        cached.parent.mkdir(parents=True, exist_ok=True)
        tmp = cached.with_suffix(".tmp")
        try:
            urllib.request.urlretrieve(url, tmp)
            tmp.rename(cached)
        except Exception as exc:
            tmp.unlink(missing_ok=True)
            raise ValueError("Could not load the checkpoint given the provided name",
                             checkpoint_path) from exc
    return torch.load(cached, map_location="cpu", weights_only=True)


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


def to_jax(state_dict: dict) -> tuple[dict, dict]:
    """The JAX package's (params, state) numpy pytrees from a state dict of
    the PyTorch model (tensors; a `model.` prefix is stripped), inverse to
    `from_jax`. Also maps a dict of gradients keyed like the parameters,
    given the batch-norm running statistics beside them."""
    sd = {k: v.detach().cpu().float().numpy() if torch.is_tensor(v) else np.asarray(v)
          for k, v in _strip_keys(state_dict).items()}
    n_layers = sum(1 for k in sd if k.startswith("transformer_blocks.layers.")
                   and k.endswith(".0.norm.gamma"))
    return torch_state_dict_to_pytree(sd, BeatThisConfig(n_layers=n_layers))


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
