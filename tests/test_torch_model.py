"""The PyTorch BeatThis forward against the JAX package's apply_beat_this on
the CPU, small config, weights carried over with from_jax. Tolerance atol
2e-3 / rtol 1e-3 in float32, as tests/test_parity_torch.py holds the JAX
model to the reference."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from beat_this_tpu.model import BeatThisConfig as JaxConfig
from beat_this_tpu.model import apply_beat_this, init_beat_this as jax_init
from beat_this_tpu_torch.io.checkpoint import from_jax, init_beat_this
from beat_this_tpu_torch.model import BeatThis, BeatThisConfig

SMALL = dict(transformer_dim=128, n_layers=2)


@pytest.fixture(scope="module")
def models():
    params, state = jax_init(3, JaxConfig(**SMALL))
    model = BeatThis(BeatThisConfig(**SMALL))
    model.load_state_dict(from_jax(params, state))
    return params, state, model.eval()


@jax.jit
def _jax_apply(params, state, x, valid):
    out, _ = apply_beat_this(params, state, x, JaxConfig(**SMALL), valid_lengths=valid)
    return out["beat"], out["downbeat"]


def _jax_logits(params, state, x, valid=None):
    out = _jax_apply(params, state, jnp.asarray(x), None if valid is None else jnp.asarray(valid))
    return tuple(np.asarray(o) for o in out)


def _torch_logits(model, x, valid=None, kernels=True):
    with torch.inference_mode():
        out = model(
            torch.from_numpy(x),
            valid_lengths=None if valid is None else torch.from_numpy(valid),
            kernels=kernels,
        )
    return out["beat"].numpy(), out["downbeat"].numpy()


@pytest.mark.parametrize("t", [64, 150])
def test_forward_matches_jax(models, t):
    params, state, model = models
    x = np.random.default_rng(t).standard_normal((2, t, 128)).astype(np.float32)
    for got, want in zip(_torch_logits(model, x), _jax_logits(params, state, x)):
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_valid_lengths_match_jax(models):
    params, state, model = models
    x = np.random.default_rng(5).standard_normal((2, 96, 128)).astype(np.float32)
    valid = np.array([96, 70], np.int32)
    got = _torch_logits(model, x, valid.astype(np.int64))
    want = _jax_logits(params, state, x, valid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-3, rtol=1e-3)
    # the masked sample equals a run on its valid prefix alone
    alone = _torch_logits(model, x[1:, :70])
    np.testing.assert_allclose(got[0][1, :70], alone[0][0], atol=2e-4, rtol=1e-4)


def test_composable_path_equals_plain_versions(models):
    """On the CPU the kernels' wrappers run their plain versions, so the
    kernel route and the composable route compute the same thing."""
    _, _, model = models
    x = np.random.default_rng(9).standard_normal((1, 80, 128)).astype(np.float32)
    for a, b in zip(_torch_logits(model, x), _torch_logits(model, x, kernels=False)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


H16 = dict(head_dim=16, transformer_dim=64, n_layers=2)


@pytest.fixture(scope="module")
def h16_models():
    """The head_dim 16 configuration, which the fused routers decline: time
    blocks through `attention_block` (flash_attention from 512 frames on),
    frequency blocks through small_attention."""
    params, state = jax_init(4, JaxConfig(**H16))
    model = BeatThis(BeatThisConfig(**H16))
    model.load_state_dict(from_jax(params, state))
    return params, state, model.eval()


def _jax_h16(params, state, x, valid=None):
    out, _ = apply_beat_this(params, state, jnp.asarray(x), JaxConfig(**H16),
                             valid_lengths=None if valid is None else jnp.asarray(valid))
    return np.asarray(out["beat"]), np.asarray(out["downbeat"])


@pytest.mark.parametrize("batch,t", [(2, 64), (1, 512)])
def test_head_dim_16_forward_matches_jax(h16_models, batch, t):
    params, state, model = h16_models
    x = np.random.default_rng(t).standard_normal((batch, t, 128)).astype(np.float32)
    got = _torch_logits(model, x)
    for g, w in zip(got, _jax_h16(params, state, x)):
        np.testing.assert_allclose(g, w, atol=2e-3, rtol=1e-3)
    for g, p in zip(got, _torch_logits(model, x, kernels=False)):
        np.testing.assert_allclose(g, p, atol=1e-6, rtol=1e-6)


def test_head_dim_16_valid_lengths_match_jax(h16_models):
    params, state, model = h16_models
    x = np.random.default_rng(6).standard_normal((2, 96, 128)).astype(np.float32)
    valid = np.array([96, 70], np.int32)
    got = _torch_logits(model, x, valid.astype(np.int64))
    for g, w in zip(got, _jax_h16(params, state, x, valid)):
        np.testing.assert_allclose(g, w, atol=2e-3, rtol=1e-3)


def test_head_dim_16_routes(h16_models, monkeypatch):
    """Per forward of the head_dim 16 model: 3 small_attention calls
    (frequency blocks), one flash_attention call per time block when
    unmasked and long enough (3 frontend + 2 main), none when masked, and no
    fused time or frequency block."""
    from beat_this_tpu_torch.ops import flash_attention, fused_freq, fused_time, small_attention

    _, _, model = h16_models
    seen = []
    for mod, name in ((flash_attention, "flash_attention"), (small_attention, "small_attention"),
                      (fused_time, "fused_time_roformer"), (fused_freq, "fused_freq_roformer")):
        monkeypatch.setattr(mod, name, lambda *a, fn=getattr(mod, name), name=name:
                            seen.append(name) or fn(*a))
    x = np.random.default_rng(7).standard_normal((1, 512, 128)).astype(np.float32)
    _torch_logits(model, x)
    assert sorted(seen) == ["flash_attention"] * 5 + ["small_attention"] * 3
    seen.clear()
    _torch_logits(model, x, np.array([400], np.int64))
    assert seen == ["small_attention"] * 3


def test_init_matches_jax_init():
    cfg = dict(transformer_dim=64, n_layers=1)
    want = from_jax(*jax_init(7, JaxConfig(**cfg)))
    got = init_beat_this(7, BeatThisConfig(**cfg))
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # and it loads strictly into the module under the reference's names
    BeatThis(BeatThisConfig(**cfg)).load_state_dict(got)


def test_state_dict_keys_are_reference_names():
    keys = set(BeatThis(BeatThisConfig(**SMALL)).state_dict())
    for key in (
        "frontend.stem.bn1d.weight",
        "frontend.stem.conv2d.weight",
        "frontend.blocks.0.partial.attnF.to_qkv.weight",
        "frontend.blocks.2.norm.running_var",
        "transformer_blocks.layers.1.0.to_out.0.weight",
        "transformer_blocks.layers.1.1.net.4.bias",
        "transformer_blocks.norm.gamma",
        "task_heads.beat_downbeat_lin.bias",
    ):
        assert key in keys, key
