"""The PyTorch layer functions against beat_this_tpu/model/layers.py on the
CPU, float32, same numpy-seeded inputs and weights. Tolerances are float32
rounding of sums of at most a few hundred terms: atol 1e-5, rtol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beat_this_tpu.model import layers as jl
from beat_this_tpu.ops.rotary import rope_tables as jax_rope_tables
from beat_this_tpu_torch.model import layers as tl
from beat_this_tpu_torch.ops.rotary import apply_rope, rope_tables

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _attention(rng, c, heads):
    p = {
        "norm_gamma": 1 + 0.1 * rng.standard_normal(c),
        "qkv_w": rng.standard_normal((c, 3 * c)) / np.sqrt(c),
        "gates_w": rng.standard_normal((c, heads)) / np.sqrt(c),
        "gates_b": 0.3 * rng.standard_normal(heads),
        "out_w": rng.standard_normal((c, c)) / np.sqrt(c),
    }
    m = tl.Attention(c, heads)
    m.load_state_dict({
        "norm.gamma": _t(p["norm_gamma"]),
        "to_qkv.weight": _t(p["qkv_w"].T),
        "to_gates.weight": _t(p["gates_w"].T),
        "to_gates.bias": _t(p["gates_b"]),
        "to_out.0.weight": _t(p["out_w"].T),
    })
    return {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}, m


def _ff(rng, c):
    p = {
        "norm_gamma": 1 + 0.1 * rng.standard_normal(c),
        "w1": rng.standard_normal((c, 4 * c)) / np.sqrt(c),
        "b1": 0.1 * rng.standard_normal(4 * c),
        "w2": rng.standard_normal((4 * c, c)) / np.sqrt(4 * c),
        "b2": 0.1 * rng.standard_normal(c),
    }
    m = tl.FeedForward(c)
    m.load_state_dict({
        "net.0.gamma": _t(p["norm_gamma"]),
        "net.1.weight": _t(p["w1"].T),
        "net.1.bias": _t(p["b1"]),
        "net.4.weight": _t(p["w2"].T),
        "net.4.bias": _t(p["b2"]),
    })
    return {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}, m


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    x[0, 0] = 0.0  # the 1e-12 clamp
    g = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    _close(tl.rms_norm(_t(x), _t(g)), jl.rms_norm(jnp.asarray(x), jnp.asarray(g)))


@pytest.mark.parametrize("n", [5, 32])
def test_rope(n):
    x = np.random.default_rng(n).standard_normal((2, 3, n, 32)).astype(np.float32)
    jcos, jsin = jax_rope_tables(n, 32)
    cos, sin = rope_tables(n, 32)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    from beat_this_tpu.ops.rotary import apply_rope as jax_apply_rope

    _close(apply_rope(_t(x), cos, sin), jax_apply_rope(jnp.asarray(x), jcos, jsin))


@pytest.mark.parametrize("masked", [False, True])
def test_attention_block(masked):
    rng = np.random.default_rng(1 + masked)
    c, heads, n = 64, 2, 40
    jp, m = _attention(rng, c, heads)
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    jrope = jax_rope_tables(n, 32)
    key_mask = None
    if masked:
        key_mask = np.arange(n)[None, :] < np.array([[n], [23]])
    want = jl.attention_block(
        jp, jnp.asarray(x), jrope, heads,
        key_mask=None if key_mask is None else jnp.asarray(key_mask),
    )
    got = tl.attention_block(
        m, _t(x), rope_tables(n, 32), heads,
        key_mask=None if key_mask is None else torch.from_numpy(key_mask),
    )
    _close(got, want)


def test_feed_forward():
    rng = np.random.default_rng(3)
    jp, m = _ff(rng, 32)
    x = rng.standard_normal((4, 9, 32)).astype(np.float32)
    _close(tl.feed_forward(m, _t(x)), jl.feed_forward(jp, jnp.asarray(x)))


def test_batch_norm_eval():
    rng = np.random.default_rng(4)
    c = 16
    p = {
        "gamma": 1 + 0.1 * rng.standard_normal(c),
        "beta": 0.1 * rng.standard_normal(c),
        "mean": 0.1 * rng.standard_normal(c),
        "var": 1 + 0.1 * np.abs(rng.standard_normal(c)),
    }
    bn = tl.BatchNorm(c)
    bn.load_state_dict({
        "weight": _t(p["gamma"]), "bias": _t(p["beta"]),
        "running_mean": _t(p["mean"]), "running_var": _t(p["var"]),
    })
    x = rng.standard_normal((2, 5, 3, c)).astype(np.float32)
    want, _ = jl.batch_norm_apply(
        {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}, jnp.asarray(x)
    )
    _close(tl.batch_norm_apply(bn, _t(x)), want)


@pytest.mark.parametrize("c_in,c_out,k_freq,stride", [(1, 32, 4, 4), (32, 64, 2, 2)])
def test_conv2d_tf(c_in, c_out, k_freq, stride):
    """The reference's OIHW (H = freq, W = time) weight against the JAX
    package's (time, freq, in, out) layout of the same numbers."""
    rng = np.random.default_rng(c_in)
    w_ref = rng.standard_normal((c_out, c_in, k_freq, 3)).astype(np.float32)
    x = rng.standard_normal((2, 11, 16, c_in)).astype(np.float32)
    want = jl.conv2d_tf(
        jnp.asarray(w_ref.transpose(3, 2, 1, 0)), jnp.asarray(x),
        stride_freq=stride, pad_time=1,
    )
    got = tl.conv2d_tf(_t(w_ref), _t(x), stride_freq=stride, pad_time=1)
    assert got.shape == want.shape
    _close(got, want, atol=1e-4, rtol=1e-5)
