"""The plain PyTorch versions of the training kernels against the JAX
package's Pallas training ops, run in interpret mode on the CPU as the JAX
package's own tests run them (pltpu.prng has no interpret rule, so at
dropout 0): `fused_time_attention_train_ref` against
`fused_time_attention_train(..., 0.0, None, interpret=True)` and
`fused_ff_train_ref` against `fused_ff_train(interpret=True)`, forward and
every gradient, on the same numpy-seeded inputs and weights. Also the
training routers: they pick the training kernels exactly where the JAX
router does.

Tolerances are the JAX tests' own: float32 attention relative max deviation
1e-4 per gradient (tests/test_fused_time.py:154-159), float32 feed-forward
atol 3e-4 (tests/test_fused_ff.py:63-67), bfloat16 relative 5e-2
(tests/test_fused_time.py:190).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beat_this_tpu.ops.fused_ff import fused_ff_train as jax_ff_train
from beat_this_tpu.ops.fused_time import fused_time_attention_train as jax_attn_train
from beat_this_tpu.ops.rotary import rope_tables as jax_rope_tables
from beat_this_tpu_torch.model import layers
from beat_this_tpu_torch.ops import fused_ff, fused_time
from beat_this_tpu_torch.ops.fused_ff import fused_ff_train, fused_ff_train_ref
from beat_this_tpu_torch.ops.fused_time import (
    fused_time_attention_train,
    fused_time_attention_train_ref,
)
from beat_this_tpu_torch.ops.rotary import rope_tables
from tests.test_torch_kernels_ref import _block, _input, _t

JAX_ATTN = ("norm_gamma", "qkv_w", "gates_w", "gates_b", "out_w")
JAX_FF = ("norm_gamma", "w1", "b1", "w2", "b2")


def _torch_grads(fn, x, module, cot):
    """Output, dx and the module's parameter gradients in the JAX layout
    (linear weights transposed to (in, out))."""
    module.requires_grad_(True).zero_grad()
    x = x.clone().requires_grad_(True)
    out = fn(x)
    (out.float() * cot).sum().backward()
    grads = [p.grad.T if p.ndim == 2 else p.grad for p in module.parameters()]
    return out.detach().float().numpy(), [x.grad.float().numpy()] + [g.numpy() for g in grads]


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max()
                 / (np.abs(np.asarray(want, np.float32)).max() + 1e-30))


@pytest.mark.parametrize(
    "heads,n,items", [(1, 140, 2), (2, 136, 2), (4, 130, 2), (8, 140, 2), (16, 129, 1)]
)
def test_attention_train_ref_matches_pallas(heads, n, items):
    c = heads * 32
    ja, _, tattn, _ = _block(heads * 7 + n, c, heads)
    x = _input(n, (items, n, c))
    cot = _input(n + 1, (items, n, c))
    jcos, jsin = jax_rope_tables(n, 32)

    def loss(x, p):
        return jnp.sum(jax_attn_train(x, p, jcos, jsin, heads, 0.0, None, True) * cot)

    want_out = jax_attn_train(jnp.asarray(x), ja, jcos, jsin, heads, 0.0, None, True)
    want_dx, want_dp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), ja)
    cos, sin = rope_tables(n, 32)
    out, got = _torch_grads(
        lambda t: fused_time_attention_train_ref(t, tattn, cos, sin, heads), _t(x), tattn,
        _t(cot))
    assert _rel(out, want_out) < 1e-4
    # module parameter order: norm.gamma, to_qkv, to_gates (weight, bias), to_out
    for got_g, want_g in zip(got, [want_dx] + [want_dp[k] for k in JAX_ATTN]):
        assert _rel(got_g, want_g) < 1e-4


def test_attention_train_ref_bf16():
    heads, n, items = 4, 140, 2
    c = heads * 32
    ja, _, tattn, _ = _block(11, c, heads)
    x = _input(12, (items, n, c))
    cot = _input(13, (items, n, c))
    jcos, jsin = jax_rope_tables(n, 32)

    def loss(x):
        out = jax_attn_train(x.astype(jnp.bfloat16), ja, jcos, jsin, heads, 0.0, None, True)
        return jnp.sum(out.astype(jnp.float32) * cot)

    want_dx = jax.grad(loss)(jnp.asarray(x))
    cos, sin = rope_tables(n, 32)
    _, got = _torch_grads(
        lambda t: fused_time_attention_train_ref(t.to(torch.bfloat16), tattn, cos, sin, heads),
        _t(x), tattn, _t(cot))
    assert _rel(got[0], want_dx) < 5e-2


@pytest.mark.parametrize("shape,c", [((3, 100), 64), ((300,), 128), ((2, 37), 512)])
def test_ff_train_ref_matches_pallas(shape, c):
    _, jf, _, tff = _block(c + 3, c, c // 32)
    x = _input(c, shape + (c,))
    cot = _input(c + 1, shape + (c,))

    def loss(x, p):
        out = jax_ff_train(x, *(p[k] for k in JAX_FF), interpret=True)
        return jnp.sum(out * cot)

    want_out = jax_ff_train(jnp.asarray(x), *(jf[k] for k in JAX_FF), interpret=True)
    want_dx, want_dp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jf)
    out, got = _torch_grads(lambda t: fused_ff_train_ref(t, tff), _t(x), tff, _t(cot))
    np.testing.assert_allclose(out, np.asarray(want_out), atol=3e-4, rtol=0)
    for got_g, want_g, key in zip(got, [want_dx] + [want_dp[k] for k in JAX_FF],
                                  ("x",) + JAX_FF):
        np.testing.assert_allclose(got_g, np.asarray(want_g), atol=3e-4, rtol=0, err_msg=key)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(fused_ff_train(_t(x), tff), fused_ff_train_ref(_t(x), tff))


def test_ff_train_ref_bf16():
    c = 64
    _, jf, _, tff = _block(5, c, 2)
    x = _input(6, (300, c))
    cot = _input(7, (300, c))

    def loss(x):
        out = jax_ff_train(x.astype(jnp.bfloat16), *(jf[k] for k in JAX_FF), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * cot)

    want_dx = jax.grad(loss)(jnp.asarray(x))
    _, got = _torch_grads(lambda t: fused_ff_train_ref(t.to(torch.bfloat16), tff), _t(x), tff,
                          _t(cot))
    assert _rel(got[0], want_dx) < 5e-2


def test_time_attention_train_router(monkeypatch):
    """time_attention_train takes the training kernel for heads 1/2/4/16 and
    the composable path for 6 (no head grouping) and 32 (above
    FUSED_TIME_TRAIN_MAX_HEADS), as tests/test_fused_time.py:207 holds the
    JAX router; sequences shorter than FLASH_MIN_SEQ take the composable
    path too, and kernels=False the kernel's plain version."""
    calls, fallbacks = [], []

    def fake_kernel(x, attn, cos, sin, heads, rate, seed):
        calls.append(heads)
        return torch.zeros_like(x)

    def fake_composable(attn, x, rope, heads, **kw):
        fallbacks.append(heads)
        return torch.zeros_like(x)

    def fake_plain(x, attn, cos, sin, heads, rate, seed):
        calls.append(("plain", heads))
        return torch.zeros_like(x)

    monkeypatch.setattr(fused_time, "fused_time_attention_train", fake_kernel)
    monkeypatch.setattr(fused_time, "fused_time_attention_train_ref", fake_plain)
    monkeypatch.setattr(layers, "attention_block", fake_composable)
    n = layers.FLASH_MIN_SEQ
    rope = rope_tables(n, 32)
    for heads in (1, 2, 4, 6, 16, 32):
        x = torch.zeros((1, n, heads * 32))
        out = layers.time_attention_train(None, x, rope, heads, dropout_rate=0.1, seed=3)
        assert out.shape == x.shape
    assert calls == [1, 2, 4, 16] and fallbacks == [6, 32]
    layers.time_attention_train(None, torch.zeros((1, n - 1, 64)), rope, 2)
    layers.time_attention_train(None, torch.zeros((1, n, 64)), rope, 2, kernels=False)
    assert calls == [1, 2, 4, 16, ("plain", 2)] and fallbacks == [6, 32, 2]


def test_ff_residual_routes_training_to_the_train_kernel(monkeypatch):
    seen = []
    monkeypatch.setattr(fused_ff, "fused_ff_train",
                        lambda x, ff, rate, seed: seen.append((rate, seed)) or x)
    monkeypatch.setattr(fused_ff, "fused_ff_train_ref",
                        lambda x, ff, rate, seed: seen.append("plain") or x)
    monkeypatch.setattr(fused_ff, "fused_ff", lambda x, ff: seen.append("eval") or x)
    x = torch.zeros((2, 3, 32))
    layers.ff_residual(None, x, train=True, dropout_rate=0.2, seed=9)
    layers.ff_residual(None, x, train=True, kernels=False)
    layers.ff_residual(None, x)
    assert seen == [(0.2, 9), "plain", "eval"]
