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
