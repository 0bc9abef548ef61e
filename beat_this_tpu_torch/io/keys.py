"""The reference state-dict key map: the torch <-> (params, state) pytree
layout conversion of beat_this_tpu/io/torch_ckpt.py, copied here (with its
helpers and names) so that the port imports nothing of the JAX package.

Linear weights are transposed to (in, out), conv kernels go OIHW (out, in,
freq, time) -> (time, freq, in, out), and batch-norm running statistics are
split into a separate `state` pytree. Key rewriting mirrors the reference
(`model.` prefix strip, `_orig_mod.` removal - beat_this/utils.py:105-111,
beat_this/model/beat_tracker.py:194-203).
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _strip_keys(state_dict: dict) -> dict:
    """Remove `model.` and `_orig_mod.` prefixes (reference
    beat_this/utils.py:105-111, beat_this/model/beat_tracker.py:194-203) and
    drop non-model entries (losses' pos_weight buffers, rotary freqs)."""
    out = {}
    for key, value in state_dict.items():
        key = key.replace("_orig_mod.", "")
        if key.startswith("model."):
            key = key[len("model.") :]
        if "rotary_embed" in key or key.endswith("num_batches_tracked"):
            continue
        if key.startswith(("beat_loss.", "downbeat_loss.")):
            continue
        out[key] = value
    return out


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _linear(sd, prefix, bias=True):
    p = {"w": _f32(sd[f"{prefix}.weight"]).T}
    if bias:
        p["b"] = _f32(sd[f"{prefix}.bias"])
    return p


def _conv(sd, key):
    # torch OIHW with H=freq, W=time  ->  ours (time, freq, in, out)
    return {"w": _f32(sd[key]).transpose(3, 2, 1, 0)}


def _bn_split(sd, prefix):
    params = {"gamma": _f32(sd[f"{prefix}.weight"]), "beta": _f32(sd[f"{prefix}.bias"])}
    stats = {
        "mean": _f32(sd[f"{prefix}.running_mean"]),
        "var": _f32(sd[f"{prefix}.running_var"]),
    }
    return params, stats


def _attention(sd, prefix):
    return {
        "norm_gamma": _f32(sd[f"{prefix}.norm.gamma"]),
        "qkv_w": _f32(sd[f"{prefix}.to_qkv.weight"]).T,
        "gates_w": _f32(sd[f"{prefix}.to_gates.weight"]).T,
        "gates_b": _f32(sd[f"{prefix}.to_gates.bias"]),
        "out_w": _f32(sd[f"{prefix}.to_out.0.weight"]).T,
    }


def _ff(sd, prefix):
    return {
        "norm_gamma": _f32(sd[f"{prefix}.net.0.gamma"]),
        "w1": _f32(sd[f"{prefix}.net.1.weight"]).T,
        "b1": _f32(sd[f"{prefix}.net.1.bias"]),
        "w2": _f32(sd[f"{prefix}.net.4.weight"]).T,
        "b2": _f32(sd[f"{prefix}.net.4.bias"]),
    }


def torch_state_dict_to_pytree(state_dict: dict, config) -> tuple[dict, dict]:
    """Convert a reference BeatThis state_dict into (params, state) pytrees.

    Accepts both bare-model and Lightning (`model.`-prefixed) dicts. The name
    scheme follows the reference module tree (beat_this/model/beat_tracker.py,
    beat_this/model/roformer.py).
    """
    sd = _strip_keys(state_dict)
    params: dict[str, Any] = {}
    state: dict[str, Any] = {}

    bn1d_p, bn1d_s = _bn_split(sd, "frontend.stem.bn1d")
    bn2d_p, bn2d_s = _bn_split(sd, "frontend.stem.bn2d")
    params["stem"] = {
        "bn1d": bn1d_p,
        "conv": _conv(sd, "frontend.stem.conv2d.weight"),
        "bn2d": bn2d_p,
    }
    state["stem"] = {"bn1d": bn1d_s, "bn2d": bn2d_s}

    params["blocks"], state["blocks"] = [], []
    for i in range(3):
        base = f"frontend.blocks.{i}"
        block: dict[str, Any] = {}
        if f"{base}.partial.attnF.norm.gamma" in sd:
            block["partial"] = {
                "attnF": _attention(sd, f"{base}.partial.attnF"),
                "ffF": _ff(sd, f"{base}.partial.ffF"),
                "attnT": _attention(sd, f"{base}.partial.attnT"),
                "ffT": _ff(sd, f"{base}.partial.ffT"),
            }
        block["conv"] = _conv(sd, f"{base}.conv2d.weight")
        bn_p, bn_s = _bn_split(sd, f"{base}.norm")
        block["bn"] = bn_p
        params["blocks"].append(block)
        state["blocks"].append({"bn": bn_s})

    params["linear"] = _linear(sd, "frontend.linear")
    params["transformer"] = {
        "layers": [
            {
                "attn": _attention(sd, f"transformer_blocks.layers.{i}.0"),
                "ff": _ff(sd, f"transformer_blocks.layers.{i}.1"),
            }
            for i in range(config.n_layers)
        ],
        "norm_gamma": _f32(sd["transformer_blocks.norm.gamma"]),
    }
    params["head"] = _linear(sd, "task_heads.beat_downbeat_lin")
    return params, state


def pytree_to_torch_state_dict(params: dict, state: dict) -> dict:
    """Inverse mapping: export (params, state) as a reference-named torch
    state_dict (numpy arrays), for checkpoint interchange with the PyTorch
    stack."""
    sd: dict[str, np.ndarray] = {}

    def put_bn(prefix, p, s):
        sd[f"{prefix}.weight"] = _f32(p["gamma"])
        sd[f"{prefix}.bias"] = _f32(p["beta"])
        sd[f"{prefix}.running_mean"] = _f32(s["mean"])
        sd[f"{prefix}.running_var"] = _f32(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)

    def put_attention(prefix, p):
        sd[f"{prefix}.norm.gamma"] = _f32(p["norm_gamma"])
        sd[f"{prefix}.to_qkv.weight"] = _f32(p["qkv_w"]).T
        sd[f"{prefix}.to_gates.weight"] = _f32(p["gates_w"]).T
        sd[f"{prefix}.to_gates.bias"] = _f32(p["gates_b"])
        sd[f"{prefix}.to_out.0.weight"] = _f32(p["out_w"]).T

    def put_ff(prefix, p):
        sd[f"{prefix}.net.0.gamma"] = _f32(p["norm_gamma"])
        sd[f"{prefix}.net.1.weight"] = _f32(p["w1"]).T
        sd[f"{prefix}.net.1.bias"] = _f32(p["b1"])
        sd[f"{prefix}.net.4.weight"] = _f32(p["w2"]).T
        sd[f"{prefix}.net.4.bias"] = _f32(p["b2"])

    put_bn("frontend.stem.bn1d", params["stem"]["bn1d"], state["stem"]["bn1d"])
    sd["frontend.stem.conv2d.weight"] = _f32(
        params["stem"]["conv"]["w"]
    ).transpose(3, 2, 1, 0)
    put_bn("frontend.stem.bn2d", params["stem"]["bn2d"], state["stem"]["bn2d"])

    for i, (block, bstate) in enumerate(zip(params["blocks"], state["blocks"])):
        base = f"frontend.blocks.{i}"
        if "partial" in block:
            put_attention(f"{base}.partial.attnF", block["partial"]["attnF"])
            put_ff(f"{base}.partial.ffF", block["partial"]["ffF"])
            put_attention(f"{base}.partial.attnT", block["partial"]["attnT"])
            put_ff(f"{base}.partial.ffT", block["partial"]["ffT"])
        sd[f"{base}.conv2d.weight"] = _f32(block["conv"]["w"]).transpose(3, 2, 1, 0)
        put_bn(f"{base}.norm", block["bn"], bstate["bn"])

    sd["frontend.linear.weight"] = _f32(params["linear"]["w"]).T
    sd["frontend.linear.bias"] = _f32(params["linear"]["b"])
    for i, layer in enumerate(params["transformer"]["layers"]):
        put_attention(f"transformer_blocks.layers.{i}.0", layer["attn"])
        put_ff(f"transformer_blocks.layers.{i}.1", layer["ff"])
    sd["transformer_blocks.norm.gamma"] = _f32(params["transformer"]["norm_gamma"])
    sd["task_heads.beat_downbeat_lin.weight"] = _f32(params["head"]["w"]).T
    sd["task_heads.beat_downbeat_lin.bias"] = _f32(params["head"]["b"])
    return sd
