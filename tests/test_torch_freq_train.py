"""The fused frequency-axis block's training op on the CPU: its plain
version `fused_freq_roformer_train_ref` against the JAX package's
`fused_freq_roformer` run in interpret mode (at dropout 0: pltpu.prng has no
interpret rule, tests/test_fused_freq.py:99-101), forward and all eleven
gradients; a float64 gradcheck with dropout on; the keep statistics of its
four dropout sites; the router and the stock model's seed draws.

Tolerances are the JAX tests' own: float32 output atol 5e-5
(tests/test_fused_freq.py:49), gradients atol 2e-4 * max(1, max |ref|)
(:92-95); bfloat16 output within 0.15 absolute (:63), gradients within a
relative max deviation of 5e-2 (tests/test_fused_time.py:190).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from beat_this_tpu.ops.fused_freq import fused_freq_roformer as jax_fused_freq
from beat_this_tpu.ops.rotary import rope_tables as jax_rope_tables
from beat_this_tpu_torch.model import layers
from beat_this_tpu_torch.model.beat_this import BeatThis, BeatThisConfig
from beat_this_tpu_torch.model.layers import Attention, FeedForward
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops import fused_freq
from beat_this_tpu_torch.ops.fused_freq import (
    fused_freq_roformer_train,
    fused_freq_roformer_train_ref,
)
from beat_this_tpu_torch.ops.rotary import rope_tables
from tests.test_torch_dropout import _gradcheck, _init
from tests.test_torch_kernels_ref import _block, _input, _t

JAX_ATTN = ("norm_gamma", "qkv_w", "gates_w", "gates_b", "out_w")
JAX_FF = ("norm_gamma", "w1", "b1", "w2", "b2")
GRADS = ("x",) + tuple("attn." + k for k in JAX_ATTN) + tuple("ff." + k for k in JAX_FF)


def _torch_grads(fn, x, attn, ff, cot):
    """Output, dx and the eleven gradients' JAX layouts (linear weights
    transposed to (in, out))."""
    for mod in (attn, ff):
        mod.requires_grad_(True).zero_grad()
    x = x.clone().requires_grad_(True)
    out = fn(x)
    (out.float() * cot).sum().backward()
    grads = [p.grad.T if p.ndim == 2 else p.grad
             for p in list(attn.parameters()) + list(ff.parameters())]
    return out.detach().float().numpy(), [x.grad.float().numpy()] + [g.numpy() for g in grads]


def _jax_grads(x, ja, jf, cot, f, dtype):
    jcos, jsin = jax_rope_tables(f, 32)

    def loss(x, a, p):
        out = jax_fused_freq(x.astype(dtype), a, p, jcos, jsin, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * cot)

    out = jax_fused_freq(jnp.asarray(x, dtype), ja, jf, jcos, jsin, interpret=True)
    dx, da, dp = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), ja, jf)
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(dx)] + [np.asarray(da[k]) for k in JAX_ATTN]
            + [np.asarray(dp[k]) for k in JAX_FF])


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max()
                 / (np.abs(np.asarray(want, np.float32)).max() + 1e-30))


# the three frontend shapes (F * C = 1024); items * F is no multiple of the
# JAX kernel's 512- and 1024-row blocks, nor (for F < 32) of the CUDA
# kernels' 32-row tiles
@pytest.mark.parametrize("f,c,items", [(32, 32, 7), (16, 64, 9), (8, 128, 13)])
def test_train_ref_matches_pallas(f, c, items):
    ja, jf, tattn, tff = _block(f * c + 1, c, c // 32)
    x = _input(f + c + 1, (items, f, c))
    cot = _input(f + c + 2, (items, f, c))
    want_out, want = _jax_grads(x, ja, jf, cot, f, jnp.float32)
    cos, sin = rope_tables(f, 32)
    out, got = _torch_grads(lambda t: fused_freq_roformer_train_ref(t, tattn, tff, cos, sin),
                            _t(x), tattn, tff, _t(cot))
    np.testing.assert_allclose(out, want_out, atol=5e-5, rtol=0)
    for name, g, w in zip(GRADS, got, want):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=2e-4 * scale, rtol=0, err_msg=name)
    # on a CPU tensor the training op is the plain version
    assert torch.equal(fused_freq_roformer_train(_t(x), tattn, tff, cos, sin, 0.1, 5),
                       fused_freq_roformer_train_ref(_t(x), tattn, tff, cos, sin, 0.1, 5))


@pytest.mark.parametrize("f,c,items", [(32, 32, 5), (16, 64, 9), (8, 128, 13)])
def test_train_ref_bf16(f, c, items):
    ja, jf, tattn, tff = _block(f * c + 2, c, c // 32)
    x = _input(f + c + 3, (items, f, c))
    cot = _input(f + c + 4, (items, f, c))
    want_out, want = _jax_grads(x, ja, jf, cot, f, jnp.bfloat16)
    cos, sin = rope_tables(f, 32)
    out, got = _torch_grads(
        lambda t: fused_freq_roformer_train_ref(t.to(torch.bfloat16), tattn, tff, cos, sin),
        _t(x), tattn, tff, _t(cot))
    assert np.abs(out - want_out).max() < 0.15
    for name, g, w in zip(GRADS, got, want):
        assert _rel(g, w) < 5e-2, name


class _Block(nn.Module):
    def __init__(self, c, heads):
        super().__init__()
        self.attn, self.ff = Attention(c, heads), FeedForward(c)


def test_train_ref_gradcheck_with_dropout():
    """Float64, rate 0.2, fixed seed: forward and backward see the same
    masks at all four sites."""
    f, c = 4, 64
    cos, sin = rope_tables(f, 32)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, f, c))).requires_grad_(True)
    _gradcheck(lambda x, b: fused_freq_roformer_train_ref(x, b.attn, b.ff, cos, sin, 0.2, 77),
               _init(_Block(c, 2), 5), x)


SITES = (drop.SITE_ATTN_PROBS, drop.SITE_ATTN_OUT, drop.SITE_FF_HIDDEN, drop.SITE_FF_OUT)


def _site_mask(site, rate=0.1):
    """A site's keep mask as the training op draws it: (item, head, query,
    key) for the probabilities, (row, column) for the other three."""
    if site == drop.SITE_ATTN_PROBS:
        m = drop.keep_mask(31, drop.SALT_FREQ, site, 600, 2, 16, 16, rate)
    else:
        m = drop.keep_mask(31, drop.SALT_FREQ, site, 1, 1, 9600, 32, rate)
    return m.reshape(-1) > 0


@pytest.mark.parametrize("site", SITES)
def test_keep_fraction_per_site(site):
    m = _site_mask(site)
    n, keep = m.numel(), 0.9
    assert abs(float(m.float().mean()) - keep) < 4 * np.sqrt(keep * (1 - keep) / n)


@pytest.mark.parametrize("a,b", [(a, b) for i, a in enumerate(SITES) for b in SITES[i + 1:]])
def test_sites_are_independent(a, b):
    """Joint keep frequency of two sites over the same count of elements
    within 4 sigma of keep^2."""
    x, y = _site_mask(a), _site_mask(b)
    p = 0.81
    assert abs(float((x & y).float().mean()) - p) < 4 * np.sqrt(p * (1 - p) / x.numel())


def test_chunked_keep_mask_equals_per_item(monkeypatch):
    """The chunked draw gives the bits of one (item, head) entry at a time."""
    want = drop.keep_mask(9, drop.SALT_FREQ, drop.SITE_ATTN_PROBS, 70, 4, 8, 8, 0.1)
    monkeypatch.setattr(drop, "MASK_CHUNK", 1)  # one entry per chunk
    assert torch.equal(drop.keep_mask(9, drop.SALT_FREQ, drop.SITE_ATTN_PROBS, 70, 4, 8, 8, 0.1),
                       want)
    monkeypatch.setattr(drop, "MASK_CHUNK", 3 * 4 * 8 * 8 + 5)  # chunks of 12 entries, ragged end
    assert torch.equal(drop.keep_mask(9, drop.SALT_FREQ, drop.SITE_ATTN_PROBS, 70, 4, 8, 8, 0.1),
                       want)


def test_freq_router_in_training_matches_jax(monkeypatch):
    """freq_roformer(train=True) takes the training op exactly where the JAX
    router (beat_this_tpu/model/layers.py:274-279) fuses, and otherwise
    attention_block plus ff_residual with the seed split in two."""
    import beat_this_tpu.model.layers as jax_layers
    import beat_this_tpu.ops.fused_freq as jax_ff_mod

    jax_fused, jax_comp = [], []
    monkeypatch.setattr(jax_layers, "_flash_enabled", lambda: True)
    monkeypatch.setattr(jax_ff_mod, "fused_freq_roformer",
                        lambda x, *a, **k: jax_fused.append(x.shape) or x)
    monkeypatch.setattr(jax_layers, "attention_block",
                        lambda p, x, *a, **k: jax_comp.append(x.shape) or jnp.zeros_like(x))
    monkeypatch.setattr(jax_layers, "ff_residual", lambda p, x, **k: x)

    ours, plain, comp, seeds = [], [], [], []
    monkeypatch.setattr(fused_freq, "fused_freq_roformer_train",
                        lambda x, a, f, cs, sn, rate, seed: ours.append((x.shape, rate, seed)) or x)
    monkeypatch.setattr(fused_freq, "fused_freq_roformer_train_ref",
                        lambda x, a, f, cs, sn, rate, seed: plain.append(x.shape) or x)
    monkeypatch.setattr(layers, "attention_block",
                        lambda a, x, rope, h, **k: comp.append(x.shape) or torch.zeros_like(x))
    monkeypatch.setattr(layers, "ff_residual",
                        lambda ff, x, **k: seeds.append(k.get("seed")) or x)
    shapes = [(f, c, heads) for f in (8, 12, 16, 32, 64)
              for c, heads in ((64, 2), (128, 4), (96, 2))]
    for f, c, heads in shapes:
        rope = rope_tables(f, 32)
        layers.freq_roformer(None, None, torch.zeros((2, f, c)), rope, heads, train=True,
                             dropout_rate=0.1, seed=3)
        jax_layers.freq_roformer(None, None, jnp.zeros((2, f, c)), jax_rope_tables(f, 32), heads,
                                 dropout_rate=0.1, rng=jax.random.PRNGKey(0))
    assert [s for s, _, _ in ours] == [tuple(s) for s in jax_fused]
    assert [tuple(s) for s in comp] == [tuple(s) for s in jax_comp]
    assert all(r == 0.1 and s == 3 for _, r, s in ours)
    assert len(seeds) == len(comp) and None not in seeds and 3 not in seeds
    layers.freq_roformer(None, None, torch.zeros((2, 8, 64)), rope_tables(8, 32), 2, train=True,
                         kernels=False, dropout_rate=0.1, seed=3)
    assert plain == [(2, 8, 64)]


def test_stock_model_draws_one_seed_per_freq_block(monkeypatch):
    """The kernel path and the plain path call the frequency blocks' training
    op with the same seeds, one per block, call for call."""
    cfg = BeatThisConfig(transformer_dim=64, n_layers=1)
    model = BeatThis(cfg)
    seen = {True: [], False: []}
    for kernels, name in ((True, "fused_freq_roformer_train"),
                          (False, "fused_freq_roformer_train_ref")):
        monkeypatch.setattr(
            fused_freq, name,
            lambda x, a, f, cs, sn, rate, seed, k=kernels: seen[k].append(seed) or x)
    x = torch.zeros((1, 16, 128))
    model(x, train=True, seed=11, kernels=True)
    model(x, train=True, seed=11, kernels=False)
    assert len(seen[True]) == 3 and seen[True] == seen[False]
    assert len(set(seen[True])) == 3
