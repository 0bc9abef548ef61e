"""The plain PyTorch versions of the attention kernels, `flash_attention_ref`
and `small_attention_ref`, against the JAX package's Pallas kernels run in
interpret mode on the CPU, as the JAX package's own tests run them
(tests/test_flash_attention.py, tests/test_small_attention.py): output and
dq, dk, dv under a random cotangent, on the same numpy-seeded inputs, at
dropout 0 (pltpu.prng has no interpret rule, and the port's Philox masks
are not the TPU's bits). With dropout the plain versions are held to
themselves: keep fraction, reproducibility, a float64 gradcheck. Then
`attention_block`'s router and `partial_roformer` against the JAX functions
(whose CPU path is plain attention).

Tolerances: float32 atol 2e-5 / rtol 1e-4 (sums of a few hundred float32
terms in another order); bfloat16 relative max deviation 2.5e-2 (the two
sides round the same quantities, the backward in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beat_this_tpu.model import layers as jl
from beat_this_tpu.ops.flash_attention import flash_attention as jax_flash
from beat_this_tpu.ops.rotary import rope_tables as jax_rope_tables
from beat_this_tpu.ops.small_attention import small_attention as jax_small
from beat_this_tpu_torch.model import layers as tl
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops import flash_attention as flash_ops
from beat_this_tpu_torch.ops import small_attention as small_ops
from beat_this_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
from beat_this_tpu_torch.ops.rotary import rope_tables
from beat_this_tpu_torch.ops.small_attention import small_attention, small_attention_ref
from tests.test_torch_layers import _ff, _t

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = 2.5e-2


def _attention(rng, c, heads, head_dim):
    """JAX parameters and the port's module of one attention whose heads are
    `head_dim` wide (inner width heads * head_dim, which need not be c)."""
    inner = heads * head_dim
    p = {
        "norm_gamma": 1 + 0.1 * rng.standard_normal(c),
        "qkv_w": rng.standard_normal((c, 3 * inner)) / np.sqrt(c),
        "gates_w": rng.standard_normal((c, heads)) / np.sqrt(c),
        "gates_b": 0.3 * rng.standard_normal(heads),
        "out_w": rng.standard_normal((inner, c)) / np.sqrt(inner),
    }
    m = tl.Attention(c, heads, head_dim)
    m.load_state_dict({
        "norm.gamma": _t(p["norm_gamma"]),
        "to_qkv.weight": _t(p["qkv_w"].T),
        "to_gates.weight": _t(p["gates_w"].T),
        "to_gates.bias": _t(p["gates_b"]),
        "to_out.0.weight": _t(p["out_w"].T),
    })
    return {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}, m


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]  # q, k, v, cot


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _torch_grads(fn, arrays, dtype, tables):
    """Output and (dq, dk, dv) of sum(fn(q, k, v) * cot) as float32 arrays."""
    q, k, v = (_t(a).to(dtype).requires_grad_(True) for a in arrays[:3])
    out = fn(q, k, v, *tables)
    (out.float() * _t(arrays[3])).sum().backward()
    return [out.detach().float().numpy()] + [t.grad.float().numpy() for t in (q, k, v)]


def _jax_grads(fn, arrays, dtype):
    cot = jnp.asarray(arrays[3])

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * cot)

    q, k, v = (jnp.asarray(a).astype(dtype) for a in arrays[:3])
    return [fn(q, k, v)] + list(jax.grad(loss, argnums=(0, 1, 2))(q, k, v))


def _compare(got, want, bf16, names=("out", "dq", "dk", "dv")):
    for name, g, w in zip(names, got, want):
        if bf16:
            assert _rel(g, w) < BF16, (name, _rel(g, w))
        else:
            np.testing.assert_allclose(g, np.asarray(w, np.float32), err_msg=name, **F32)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("n,d", [(128, 16), (200, 32), (300, 16)])
def test_flash_ref_matches_pallas(n, d, rope, bf16):
    arrays = _qkv(n + d + rope, (3, n, d))
    jtab = jax_rope_tables(n, d) if rope else (None, None)
    tab = rope_tables(n, d) if rope else (None, None)
    want = _jax_grads(
        lambda q, k, v: jax_flash(q, k, v, block_q=128, block_k=128, interpret=True,
                                  rope_cos=jtab[0], rope_sin=jtab[1]),
        arrays, jnp.bfloat16 if bf16 else jnp.float32)
    got = _torch_grads(flash_attention_ref, arrays, torch.bfloat16 if bf16 else torch.float32,
                       tab)
    _compare(got, want, bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("f,d,items", [(8, 16, 300), (16, 32, 37), (32, 16, 70), (8, 32, 5),
                                       (4, 16, 50), (2, 32, 21), (1, 16, 130)])
def test_small_ref_matches_pallas(f, d, items, bf16):
    """Every F the CUDA kernels take (the TPU kernel takes any F dividing
    128), at item counts that are no multiple of its 128 * 16 / F per
    program."""
    arrays = _qkv(f + d + items, (items, f, d))
    jtab, tab = jax_rope_tables(f, d), rope_tables(f, d)
    want = _jax_grads(
        lambda q, k, v: jax_small(q, k, v, interpret=True, rope_cos=jtab[0], rope_sin=jtab[1]),
        arrays, jnp.bfloat16 if bf16 else jnp.float32)
    got = _torch_grads(small_attention_ref, arrays, torch.bfloat16 if bf16 else torch.float32,
                       tab)
    if f == 1:
        # one key: the softmax is constant and dq = dk = 0; each side gives the
        # rounding of dp - delta, within the float32 tolerance's absolute part
        for g, w in zip(got[1:3], want[1:3]):
            assert max(np.abs(g).max(), np.abs(np.asarray(w, np.float32)).max()) < F32["atol"]
        _compare([got[0], got[3]], [want[0], want[3]], bf16, ("out", "dv"))
    else:
        _compare(got, want, bf16)


def test_small_ref_without_tables_matches_pallas():
    arrays = _qkv(5, (9, 16, 16))
    want = _jax_grads(lambda q, k, v: jax_small(q, k, v, interpret=True), arrays, jnp.float32)
    _compare(_torch_grads(small_attention_ref, arrays, torch.float32, ()), want, False)


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    q, k, v, _ = (_t(a) for a in _qkv(1, (2, 40, 16)))
    cos, sin = rope_tables(40, 16)
    assert torch.equal(flash_attention(q, k, v, cos, sin, 0.2, 7, 2),
                       flash_attention_ref(q, k, v, cos, sin, 0.2, 7, 2))
    q, k, v, _ = (_t(a) for a in _qkv(2, (6, 8, 16)))
    cos, sin = rope_tables(8, 16)
    assert torch.equal(small_attention(q, k, v, cos, sin, 0.2, 7, 3),
                       small_attention_ref(q, k, v, cos, sin, 0.2, 7, 3))


@pytest.mark.parametrize("name", ["flash", "small"])
def test_wrappers_reject_other_devices_and_shapes(name):
    """A tensor that is neither on the CPU nor on a CUDA device raises, and
    so does what the kernels do not take: nothing falls back."""
    fn, check = ((flash_attention, flash_ops.check_qkv) if name == "flash"
                 else (small_attention, small_ops._check))
    args = () if name == "small" else ("flash_attention",)
    q = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(q, q, q)

    class OnCard:
        """Stands in for a CUDA tensor in the shape and dtype checks."""

        def __init__(self, shape, dtype=torch.float32):
            self.shape, self.dtype, self.ndim = torch.Size(shape), dtype, len(shape)
            self.device = torch.device("cuda", 0)

    t = OnCard((2, 8, 24))
    with pytest.raises(ValueError, match=r"head_dim in \(16, 32\)"):
        check(*args, t, t, t, None, None)
    t = OnCard((2, 8, 16))
    with pytest.raises(ValueError, match="one shape"):
        check(*args, t, t, OnCard((2, 9, 16)), None, None)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        h = OnCard((2, 8, 16), torch.float16)
        check(*args, h, h, h, None, None)
    with pytest.raises(ValueError, match="rotation tables"):
        check(*args, t, t, t, torch.zeros(7, 8), torch.zeros(7, 8))
    if name == "small":
        t = OnCard((2, 24, 16))
        with pytest.raises(ValueError, match=r"sequence lengths \(1, 2, 4, 8, 16, 32\)"):
            check(t, t, t, None, None)


# -- dropout: the plain versions against themselves ------------------------------


def _ones(shape):
    """q = k = 0 and v = identity-like: the output shows the kept
    probabilities themselves."""
    items, n, d = shape
    q = torch.zeros(shape)
    return q, q.clone(), torch.ones(shape)


@pytest.mark.parametrize("ref,shape", [(flash_attention_ref, (4, 600, 16)),
                                       (small_attention_ref, (3000, 32, 16))])
def test_dropout_keeps_the_expected_fraction(ref, shape):
    """With equal scores every probability is 1 / n, so with v = 1 the output
    is the row's kept fraction times 1 / (1 - rate)."""
    q, k, v = _ones(shape)
    out = ref(q, k, v, None, None, 0.2, 11, 2)
    kept = float(out[..., 0].mean()) * 0.8
    assert abs(kept - 0.8) < 0.01
    assert torch.equal(out, ref(q, k, v, None, None, 0.2, 11, 2))  # same seed, same mask
    assert not torch.equal(out, ref(q, k, v, None, None, 0.2, 12, 2))
    assert torch.equal(ref(q, k, v, None, None, 0.2, None, 2), ref(q, k, v))  # no seed: off


def test_dropout_coordinates_are_item_head_row_col():
    """Entry e of (bh, n, n) draws the mask `keep_mask` gives (e // heads,
    e % heads): the bits `attention_block`'s plain torch path draws."""
    heads, n = 3, 24
    q, k, _ = _ones((2 * heads, n, 16))
    v = torch.eye(n)[None, :, :16].repeat(2 * heads, 1, 1)  # o[:, i, j] = p_ij keep_ij, j < 16
    out = flash_attention_ref(q, k, v, None, None, 0.2, 5, heads)
    keep = drop.keep_mask(5, drop.SALT_ATTN, drop.SITE_ATTN_PROBS, 2, heads, n, n, 0.2)
    np.testing.assert_allclose(out.numpy(), keep.reshape(2 * heads, n, n)[..., :16].numpy() / n,
                               rtol=1e-6)
    small = small_attention_ref(q[:, :16], k[:, :16], v[:, :16], None, None, 0.2, 5, heads)
    keep = drop.keep_mask(5, drop.SALT_ATTN, drop.SITE_ATTN_PROBS, 2, heads, 16, 16, 0.2)
    np.testing.assert_allclose(small.numpy(), keep.reshape(2 * heads, 16, 16).numpy() / 16,
                               rtol=1e-6)


@pytest.mark.parametrize("ref,shape", [(flash_attention_ref, (3, 20, 16)),
                                       (small_attention_ref, (5, 8, 16))])
def test_ref_gradcheck_with_dropout(ref, shape):
    rng = np.random.default_rng(shape[1])
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)
               for _ in range(3))
    cos, sin = rope_tables(shape[1], shape[2])
    assert torch.autograd.gradcheck(
        lambda q, k, v: ref(q, k, v, cos.double(), sin.double(), 0.2, 99, 3), (q, k, v),
        fast_mode=True)


def test_flash_ref_chunks_change_nothing(monkeypatch):
    """Chunked over the leading entries (each chunk recomputed in the
    backward), output and gradients equal the one-chunk run's, with the
    dropout mask following the entry's index."""
    arrays = _qkv(3, (5, 40, 16))
    tab = rope_tables(40, 16)

    def run():
        return _torch_grads(lambda q, k, v, *t: flash_attention_ref(q, k, v, *t, 0.2, 4, 2),
                            arrays, torch.float32, tab)

    whole = run()
    monkeypatch.setattr(flash_ops, "REF_CHUNK_ELEMS", 2 * 40 * 40)
    for a, b in zip(whole, run()):
        np.testing.assert_array_equal(a, b)


# -- the router and its callers ----------------------------------------------------


def _jax_block(seed, c, heads, n, head_dim, masked=False):
    rng = np.random.default_rng(seed)
    jp, m = _attention(rng, c, heads, head_dim)
    x = rng.standard_normal((2, n, c)).astype(np.float32)
    key_mask = np.arange(n)[None, :] < np.array([[n], [n - 5]]) if masked else None
    want = jl.attention_block(jp, jnp.asarray(x), jax_rope_tables(n, head_dim), heads,
                              key_mask=None if key_mask is None else jnp.asarray(key_mask))
    return m, _t(x), None if key_mask is None else torch.from_numpy(key_mask), want


@pytest.mark.parametrize("n,masked,route", [(512, False, "flash"), (16, False, "small"),
                                            (512, True, "sdpa"), (24, False, "sdpa")])
def test_attention_block_router(monkeypatch, n, masked, route):
    """The JAX router's three branches, each equal to the JAX
    attention_block on the CPU, and kernels=True equal to kernels=False on
    CPU tensors."""
    c, heads, head_dim = 32, 2, 16
    m, x, key_mask, want = _jax_block(n + masked, c, heads, n, head_dim, masked)
    seen = []
    for mod, kernel, plain, tag in ((flash_ops, "flash_attention", "flash_attention_ref", "flash"),
                                    (small_ops, "small_attention", "small_attention_ref", "small")):
        for fn_name, kind in ((kernel, "kernel"), (plain, "plain")):
            fn = getattr(mod, fn_name)
            monkeypatch.setattr(
                mod, fn_name,
                lambda *a, fn=fn, tag=tag, kind=kind: seen.append((tag, kind)) or fn(*a))
    monkeypatch.setattr(tl, "sdpa", lambda *a, fn=tl.sdpa, **kw: seen.append(("sdpa", "plain"))
                        or fn(*a, **kw))
    rope = rope_tables(n, head_dim)
    got = tl.attention_block(m, x, rope, heads, key_mask=key_mask)
    plain = tl.attention_block(m, x, rope, heads, key_mask=key_mask, kernels=False)
    # on a CPU tensor a kernel's wrapper runs its plain version
    first = [("sdpa", "plain")] if route == "sdpa" else [(route, "kernel"), (route, "plain")]
    assert seen == first + [(route, "plain")]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    assert torch.equal(got, plain)


def test_attention_block_draws_one_mask_on_every_route():
    """The flash and small routes drop the probabilities `sdpa` would drop
    for the same seed (coordinates item, head, row, column)."""
    c, heads, head_dim = 32, 2, 16
    for n in (16, 512):
        m, x, _, _ = _jax_block(n, c, heads, n, head_dim)
        rope = rope_tables(n, head_dim)
        got = tl.attention_block(m, x, rope, heads, dropout_rate=0.2, seed=21)
        # the sdpa branch on the same input: an all-true key mask changes nothing
        want = tl.attention_block(m, x, rope, heads, dropout_rate=0.2, seed=21,
                                  key_mask=torch.ones((2, n), dtype=torch.bool))
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **F32)
        assert not torch.equal(got, tl.attention_block(m, x, rope, heads))


@pytest.mark.parametrize("direction,t,f", [("F", 5, 16), ("T", 512, 3)])
def test_partial_roformer(direction, t, f):
    c, head_dim = 32, 16
    rng = np.random.default_rng(t)
    ja, attn = _attention(rng, c, c // head_dim, head_dim)
    jf, ff = _ff(rng, c)
    x = rng.standard_normal((2, t, f, c)).astype(np.float32)
    want = jl.partial_roformer({"attn": ja, "ff": jf}, jnp.asarray(x), direction, head_dim)
    got = tl.partial_roformer(attn, ff, _t(x), direction, head_dim)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert torch.equal(got, tl.partial_roformer(attn, ff, _t(x), direction, head_dim,
                                                kernels=False))
    # training at dropout 0 is the same function, with and without a seed
    for kernels in (True, False):
        trained = tl.partial_roformer(attn, ff, _t(x), direction, head_dim, kernels=kernels,
                                      train=True, dropout_rate=0.0, seed=3)
        np.testing.assert_allclose(trained.detach().numpy(), got.detach().numpy(), atol=1e-5,
                                   rtol=1e-5)
    dropped = tl.partial_roformer(attn, ff, _t(x), direction, head_dim, train=True,
                                  dropout_rate=0.2, seed=3)
    assert not torch.allclose(dropped, got, atol=1e-3)
    with pytest.raises(ValueError, match="direction"):
        tl.partial_roformer(attn, ff, _t(x), "x", head_dim)


def test_plain_training_attention_is_recomputed(monkeypatch):
    """Without kernels the training attention of `time_attention_train`,
    `freq_roformer` and `partial_roformer` runs under `recomputed` when the
    fused routers decline the shape, so it keeps no (n, n) tensor; with
    kernels it runs directly. Gradients are the same either way."""
    c, heads, head_dim, n = 32, 2, 16, 16
    rng = np.random.default_rng(0)
    _, attn = _attention(rng, c, heads, head_dim)
    _, ff = _ff(rng, c)
    rope = rope_tables(n, head_dim)
    calls = []
    monkeypatch.setattr(tl, "recomputed",
                        lambda fn, *a, real=tl.recomputed, **kw: calls.append(fn.__name__)
                        or real(fn, *a, **kw))

    def grad_of(fn):
        x = _t(rng.standard_normal((3, n, c))).requires_grad_(True)
        fn(x).square().sum().backward()
        return x

    for kernels, expect in ((True, []), (False, ["attention_block"])):
        calls.clear()
        grad_of(lambda x: tl.time_attention_train(attn, x, rope, heads, dropout_rate=0.1, seed=1,
                                                  kernels=kernels))
        assert calls == expect
    calls.clear()
    grad_of(lambda x: tl.freq_roformer(attn, ff, x, rope, heads, kernels=False, train=True,
                                       dropout_rate=0.1, seed=2))
    assert calls == ["attention_block", "fused_ff_train_ref"]
    x = _t(rng.standard_normal((3, n, c)))
    outs = []
    for kernels in (True, False):
        xg = x.clone().requires_grad_(True)
        tl.time_attention_train(attn, xg, rope, heads, dropout_rate=0.1, seed=1,
                                kernels=kernels).square().sum().backward()
        outs.append(xg.grad)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-6, rtol=1e-5)
