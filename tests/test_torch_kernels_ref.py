"""The plain PyTorch versions of the three ported kernels against the JAX
package's Pallas ops, run in interpret mode on the CPU as the JAX package's
own tests run them (tests/test_fused_ff.py, test_fused_time.py,
test_fused_freq.py). Same numpy-seeded inputs and weights on both sides.

Tolerances: float32 atol 1e-4 (sums of up to 4 C = 512 terms of O(1)
values, taken in another order); bfloat16 relative max deviation < 3e-2
(tests/test_fused_time.py:82-83), since the two sides round intermediates
to bfloat16 at different places.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beat_this_tpu.ops.fused_ff import fused_ff as jax_fused_ff
from beat_this_tpu.ops.fused_freq import fused_freq_roformer as jax_fused_freq
from beat_this_tpu.ops.fused_time import fused_time_roformer as jax_fused_time
from beat_this_tpu.ops.rotary import rope_tables as jax_rope_tables
from beat_this_tpu_torch.model.layers import Attention, FeedForward
from beat_this_tpu_torch.ops.fused_ff import fused_ff, fused_ff_ref
from beat_this_tpu_torch.ops.fused_freq import fused_freq_roformer, fused_freq_roformer_ref
from beat_this_tpu_torch.ops.fused_time import fused_time_roformer, fused_time_roformer_ref
from beat_this_tpu_torch.ops.rotary import rope_tables

F32_ATOL = 1e-4
BF16_REL = 3e-2


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _block(seed, c, heads):
    """JAX parameter dicts and the equal PyTorch modules."""
    rng = np.random.default_rng(seed)
    m = 4 * c
    attn = {
        "norm_gamma": 1 + 0.1 * rng.standard_normal(c),
        "qkv_w": rng.standard_normal((c, 3 * c)) / np.sqrt(c),
        "gates_w": rng.standard_normal((c, heads)) / np.sqrt(c),
        "gates_b": 0.3 * rng.standard_normal(heads),
        "out_w": rng.standard_normal((c, c)) / np.sqrt(c),
    }
    ff = {
        "norm_gamma": 1 + 0.1 * rng.standard_normal(c),
        "w1": rng.standard_normal((c, m)) / np.sqrt(c),
        "b1": 0.1 * rng.standard_normal(m),
        "w2": rng.standard_normal((m, c)) / np.sqrt(m),
        "b2": 0.1 * rng.standard_normal(c),
    }
    tattn, tff = Attention(c, heads), FeedForward(c)
    tattn.load_state_dict({
        "norm.gamma": _t(attn["norm_gamma"]),
        "to_qkv.weight": _t(attn["qkv_w"].T),
        "to_gates.weight": _t(attn["gates_w"].T),
        "to_gates.bias": _t(attn["gates_b"]),
        "to_out.0.weight": _t(attn["out_w"].T),
    })
    tff.load_state_dict({
        "net.0.gamma": _t(ff["norm_gamma"]),
        "net.1.weight": _t(ff["w1"].T),
        "net.1.bias": _t(ff["b1"]),
        "net.4.weight": _t(ff["w2"].T),
        "net.4.bias": _t(ff["b2"]),
    })

    def to_jax(p):
        return {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}

    return to_jax(attn), to_jax(ff), tattn.requires_grad_(False), tff.requires_grad_(False)


def _input(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel_dev(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("c", [32, 64, 128, 512])
def test_fused_ff_ref_matches_pallas(c):
    ja, jf, _, tff = _block(c, c, c // 32)
    x = _input(c + 1, (2, 37, c))
    want = jax_fused_ff(
        jnp.asarray(x), jf["norm_gamma"], jf["w1"], jf["b1"], jf["w2"], jf["b2"],
        interpret=True,
    )
    got = fused_ff_ref(_t(x), tff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_ATOL)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(fused_ff(_t(x), tff), got)


def test_fused_ff_ref_bf16():
    c = 64
    ja, jf, _, tff = _block(5, c, 2)
    x = _input(6, (3, 20, c))
    want = jax_fused_ff(
        jnp.asarray(x, jnp.bfloat16), jf["norm_gamma"], jf["w1"], jf["b1"], jf["w2"],
        jf["b2"], interpret=True,
    )
    got = fused_ff_ref(_t(x).to(torch.bfloat16), tff)
    assert _rel_dev(got.float(), want.astype(jnp.float32)) < BF16_REL


@pytest.mark.parametrize(
    "heads,n,items",
    [(1, 160, 3), (2, 128, 2), (4, 130, 2), (16, 96, 1)],
)
def test_fused_time_ref_matches_pallas(heads, n, items):
    c = heads * 32
    ja, jf, tattn, tff = _block(heads * 100 + n, c, heads)
    x = _input(n, (items, n, c))
    jcos, jsin = jax_rope_tables(n, 32)
    want = jax_fused_time(jnp.asarray(x), ja, jf, jcos, jsin, heads, interpret=True)
    cos, sin = rope_tables(n, 32)
    got = fused_time_roformer_ref(_t(x), tattn, tff, cos, sin, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_ATOL)
    assert torch.equal(fused_time_roformer(_t(x), tattn, tff, cos, sin, heads), got)


def test_fused_time_ref_bf16():
    heads, n, items = 4, 100, 2
    c = heads * 32
    ja, jf, tattn, tff = _block(7, c, heads)
    x = _input(8, (items, n, c))
    jcos, jsin = jax_rope_tables(n, 32)
    want = jax_fused_time(
        jnp.asarray(x, jnp.bfloat16), ja, jf, jcos, jsin, heads, interpret=True
    )
    cos, sin = rope_tables(n, 32)
    got = fused_time_roformer_ref(_t(x).to(torch.bfloat16), tattn, tff, cos, sin, heads)
    assert _rel_dev(got.float(), want.astype(jnp.float32)) < BF16_REL


@pytest.mark.parametrize("f,c,items", [(32, 32, 6), (16, 64, 8), (8, 128, 12)])
def test_fused_freq_ref_matches_pallas(f, c, items):
    ja, jf, tattn, tff = _block(f * c, c, c // 32)
    x = _input(f + c, (items, f, c))
    jcos, jsin = jax_rope_tables(f, 32)
    want = jax_fused_freq(jnp.asarray(x), ja, jf, jcos, jsin, interpret=True)
    cos, sin = rope_tables(f, 32)
    got = fused_freq_roformer_ref(_t(x), tattn, tff, cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_ATOL)
    assert torch.equal(fused_freq_roformer(_t(x), tattn, tff, cos, sin), got)


def test_fused_freq_ref_bf16():
    f, c, items = 16, 64, 8
    ja, jf, tattn, tff = _block(9, c, 2)
    x = _input(10, (items, f, c))
    jcos, jsin = jax_rope_tables(f, 32)
    want = jax_fused_freq(jnp.asarray(x, jnp.bfloat16), ja, jf, jcos, jsin, interpret=True)
    cos, sin = rope_tables(f, 32)
    got = fused_freq_roformer_ref(_t(x).to(torch.bfloat16), tattn, tff, cos, sin)
    assert _rel_dev(got.float(), want.astype(jnp.float32)) < BF16_REL
