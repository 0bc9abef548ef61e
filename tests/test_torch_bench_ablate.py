"""The plain PyTorch versions of the ablation kernels
(`beat_this_tpu_torch/bench/`) against the JAX side of the three tools, on
the CPU, same numpy-seeded inputs on both sides.

* bench_flash_ablate.py: the tool is loaded by path and its
  `make_kernel(mode, block_k)` runs in this file's own
  `pl.pallas_call(..., interpret=True)` at (2, 256, 32), block_k 128, with
  real rotation tables, every mode. float32 <= 2e-3 absolute, bfloat16
  < 2.5e-2 relative. `noexp` divides by a sum of scores that crosses zero:
  its denominators are held on every row and its output on the rows with
  |l| >= 1 (on the others a float32 sum's order moves the quotient by
  percents on either side); the numerator o * l is held on every row,
  relative to its largest entry: float32 <= 1e-4, bfloat16 < 2.5e-2.
* bench_fused_freq_ablate.py and bench_softmax_variants.py define their
  bodies inside `main()`, which cannot be imported. The JAX side is built
  here from the same package helpers in the same order, or transcribed,
  each with the tool's lines beside it; the `full` stage is also held to
  `fused_freq_roformer(interpret=True)`. float32 relative max deviation
  <= 1e-4 (sums in another order), bfloat16 < 3e-2 (the two sides round
  intermediates at different places; tests/test_fused_time.py:82-83).
* On an input built to separate them, no two variants that differ in their
  arithmetic give the same output, so a plain version cannot collapse two.
"""

import functools
import importlib.util
import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from beat_this_tpu.ops import fused_freq as jf
from beat_this_tpu.ops.fused_ff import _gelu_exact
from beat_this_tpu.ops.fused_freq import fused_freq_roformer as jax_fused_freq
from beat_this_tpu.ops.rotary import rope_tables as jax_rope_tables
from beat_this_tpu.ops.small_attention import _same_item_mask
from beat_this_tpu_torch.bench import flash_ablate, fused_freq_ablate, softmax_variants
from beat_this_tpu_torch.ops.rotary import rope_tables

TOOLS = Path(__file__).resolve().parent.parent / "tools"
DTYPES = [("float32", torch.float32, jnp.float32), ("bfloat16", torch.bfloat16, jnp.bfloat16)]
F32_REL, BF16_REL = 1e-4, 3e-2


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t):
    return t.float().numpy()


def _jnp(t, dtype):
    return jnp.asarray(_np(t)).astype(dtype)


# -- bench_flash_ablate.py ------------------------------------------------------


@pytest.fixture(scope="module")
def flash_tool():
    spec = importlib.util.spec_from_file_location(
        "bench_flash_ablate_tool", TOOLS / "bench_flash_ablate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tool_flash(tool, mode, block_k, q, k, v, cosf, sinf):
    """The tool's kernel at one query block over the whole sequence
    (bench_flash_ablate.py:101-114, interpret mode)."""
    bh, n, d = q.shape
    tab = pl.BlockSpec((1, n, d), lambda b, i: (0, 0, 0))
    row = pl.BlockSpec((1, n, d), lambda b, i: (b, 0, 0))
    return pl.pallas_call(
        tool.make_kernel(mode, block_k), grid=(bh, 1), in_specs=[row, row, row, tab, tab],
        out_specs=row, out_shape=jax.ShapeDtypeStruct((bh, n, d), q.dtype), interpret=True,
    )(q, k, v, cosf, sinf)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("mode", flash_ablate.MODES)
def test_flash_variant_against_the_tool_kernel(flash_tool, mode, name, tdtype, jdtype):
    bh, n, d, block_k = 2, 256, 32, 128
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(bh, n, d).astype(np.float32)).to(tdtype)
               for _ in range(3))
    cos, sin = rope_tables(n, d)
    got, den = flash_ablate.flash_variant(q, k, v, cos, sin, mode, block_k, with_denominator=True)
    cosf = jnp.repeat(jnp.asarray(cos.numpy()), 2, axis=-1)[None]
    sinf = jnp.repeat(jnp.asarray(sin.numpy()), 2, axis=-1)[None]
    want = np.asarray(_tool_flash(flash_tool, mode, block_k, _jnp(q, jdtype), _jnp(k, jdtype),
                                  _jnp(v, jdtype), cosf, sinf).astype(jnp.float32))
    assert got.dtype == tdtype and got.shape == (bh, n, d)
    got = _np(got)
    if mode == "mxu_only":
        assert np.array_equal(_np(den), np.full((bh, n), n // block_k, np.float32))
    if mode == "noexp":
        den = _np(den)[..., None]
        num = _rel(got * den, want * den)  # every row, the dropped ones too
        assert num <= F32_REL if tdtype == torch.float32 else num < 2.5e-2
        keep = np.abs(den[..., 0]) >= 1.0
        assert keep.mean() > 0.9
        got, want = got[keep], want[keep]
    if tdtype == torch.float32:
        assert np.abs(got - want).max() <= 2e-3
    else:
        assert _rel(got, want) < 2.5e-2


def test_flash_variant_full_is_the_models_forward():
    from beat_this_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(3, 150, 16).astype(np.float32)) for _ in range(3))
    cos, sin = rope_tables(150, 16)
    got = flash_ablate.flash_variant(q, k, v, cos, sin, "full", 64)
    np.testing.assert_allclose(got, flash_attention(q, k, v, cos, sin), atol=2e-6)
    with pytest.raises(ValueError, match="mode must be one of"):
        flash_ablate.flash_variant(q, k, v, cos, sin, "softmax_only")


# -- bench_fused_freq_ablate.py ---------------------------------------------------


def _jax_stage(stage, x, p, f, heads):
    """tools/bench_fused_freq_ablate.py:make_kernel (:47-98) on one block of
    rows, from the package's helpers in the tool's order."""
    rows, c = x.shape
    dtype = x.dtype
    if stage == "copy":  # :54-56
        return x
    g = jf._rms(x.astype(jnp.float32), p["ga"]).astype(dtype)  # :57
    if stage == "rms":  # :58-60
        return g
    qkv = jf._qkv_of(g, p["wqkv"])  # :61
    if stage == "qkv":  # :62-64
        return qkv[:, :c]
    if stage in ("attn", "full"):  # :65-78
        o = jf._attention(qkv, c, heads, f, p["cos"], p["sin"], _same_item_mask(f), None, 0.0,
                          dtype)
        sig32 = jf._gates_sig(g, p["wg"], p["bg"])
        attn = jax.lax.dot_general(
            o * jf._gate_full(sig32, rows, c, heads, dtype), p["wout"],
            dimension_numbers=(((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
        x2_32 = x.astype(jnp.float32) + attn
    else:  # "ff", :79-80
        x2_32 = x.astype(jnp.float32)
    if stage == "attn":  # :81-83
        return x2_32.astype(dtype)
    g2 = jf._rms(x2_32, p["gf"])  # :84-96
    h1 = jax.lax.dot_general(
        g2.astype(dtype), p["w1"], dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32) + p["b1"]
    h1 = _gelu_exact(h1)
    y = jax.lax.dot_general(
        h1.astype(dtype), p["w2"], dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32) + p["b2"]
    return (x2_32 + y).astype(dtype)


def _freq_case(c, f, tdtype, jdtype):
    """The bench's block on 256 rows (two 128-row packs), and the same numbers
    as the tool's kernel arguments (:111-122) and as the JAX op's dicts."""
    heads = c // 32
    x, (attn, ff), (cos, sin) = fused_freq_ablate.make_case(
        np.random.RandomState(c), c, f, 256 // f, torch.device("cpu"), tdtype)
    norm, lin1, _, _, lin2, _ = ff.net
    jcos, jsin = jax_rope_tables(f, 32)
    cosf, sinf = jf._rope_full_tables(jcos, jsin, f)
    wd = jdtype
    args = {
        "ga": _jnp(attn.norm.gamma, jnp.float32)[None], "wqkv": _jnp(attn.to_qkv.weight.T, wd),
        "wg": jnp.pad(_jnp(attn.to_gates.weight.T, wd), ((0, 0), (0, 128 - heads))),
        "bg": jnp.pad(_jnp(attn.to_gates.bias, jnp.float32)[None], ((0, 0), (0, 128 - heads))),
        "wout": _jnp(attn.to_out[0].weight.T, wd), "gf": _jnp(norm.gamma, jnp.float32)[None],
        "w1": _jnp(lin1.weight.T, wd), "b1": _jnp(lin1.bias, jnp.float32)[None],
        "w2": _jnp(lin2.weight.T, wd), "b2": _jnp(lin2.bias, jnp.float32)[None],
        "cos": cosf, "sin": sinf,
    }
    jattn = {"norm_gamma": args["ga"][0], "qkv_w": _jnp(attn.to_qkv.weight.T, jnp.float32),
             "gates_w": _jnp(attn.to_gates.weight.T, jnp.float32),
             "gates_b": _jnp(attn.to_gates.bias, jnp.float32),
             "out_w": _jnp(attn.to_out[0].weight.T, jnp.float32)}
    jff = {"norm_gamma": args["gf"][0], "w1": _jnp(lin1.weight.T, jnp.float32),
           "b1": args["b1"][0], "w2": _jnp(lin2.weight.T, jnp.float32), "b2": args["b2"][0]}
    return x, (attn, ff), (cos, sin), args, (jattn, jff, jcos, jsin)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("stage", fused_freq_ablate.STAGES)
@pytest.mark.parametrize("c,f", fused_freq_ablate.SHAPES)
def test_ablate_stage_against_the_tool_body(c, f, stage, name, tdtype, jdtype):
    x, params, (cos, sin), args, (jattn, jff, jcos, jsin) = _freq_case(c, f, tdtype, jdtype)
    got = fused_freq_ablate.ablate_stage(x, params, stage, cos, sin)
    assert got.dtype == tdtype and got.shape == x.shape
    jx = _jnp(x, jdtype)
    want = _jax_stage(stage, jx.reshape(256, c), args, f, c // 32).astype(jnp.float32)
    limit = F32_REL if tdtype == torch.float32 else BF16_REL
    assert _rel(_np(got).reshape(256, c), want) < limit
    if stage == "full":  # the real op, as tests/test_fused_freq.py runs it
        op = jax_fused_freq(jx, jattn, jff, jcos, jsin, interpret=True).astype(jnp.float32)
        assert _rel(_np(got), op) < limit
    if stage == "copy":
        assert torch.equal(got, x)


def test_ablate_stages_add_up():
    """ff(attn(x)) is the block: the stages are cuts of one computation."""
    x, params, (cos, sin), _, _ = _freq_case(64, 16, torch.float32, jnp.float32)
    attn_out = fused_freq_ablate.ablate_stage(x, params, "attn", cos, sin)
    full = fused_freq_ablate.ablate_stage(x, params, "full", cos, sin)
    np.testing.assert_allclose(
        fused_freq_ablate.ablate_stage(attn_out, params, "ff", cos, sin), full, atol=1e-5)
    with pytest.raises(ValueError, match="stage must be one of"):
        fused_freq_ablate.ablate_stage(x, params, "softmax", cos, sin)


# -- bench_softmax_variants.py ----------------------------------------------------


def _jax_attn_variant(q, k, v, mask, maskcol, gh, variant):
    """tools/bench_softmax_variants.py:attn_kernel (:74-148) for one item:
    q (pre-scaled), k, v (n, gh * 32), mask (1, n) and maskcol (n, 1) float32."""
    n_pad = q.shape[0]
    dt = q.dtype  # the tool's bfloat16
    ones_col = jnp.ones((n_pad, 1), dt)  # :79
    folded = variant in ("kfold", "b16s", "b16sfold")  # :80
    outs = []
    for j in range(gh):  # :82
        hsl = slice(j * 32, (j + 1) * 32)
        q_h, k_h = q[:, hsl], k[:, hsl]
        if folded:  # :85-89
            q_h = jnp.concatenate([q_h, ones_col], axis=1)
            k_h = jnp.concatenate([k_h, maskcol.astype(dt)], axis=1)
        sdtype = dt if variant in ("b16s", "b16sfold") else jnp.float32  # :90-93
        s = jax.lax.dot_general(q_h, k_h, dimension_numbers=(((1,), (1,)), ((), ())),
                                preferred_element_type=sdtype)  # :94-98
        if not folded:  # :99-100
            s = s + mask
        if variant in ("b16s", "b16sfold"):  # :101-105
            m = jnp.max(s, axis=1, keepdims=True)
            p = jnp.exp2(s.astype(jnp.float32) - m.astype(jnp.float32)).astype(dt)
        elif variant == "kfold":  # :106-108
            m = jnp.max(s, axis=1, keepdims=True)
            p = jnp.exp2(s - m).astype(dt)
        elif variant == "nosmax":  # :109-110
            p = s.astype(dt)
        elif variant == "nomax":  # :111-112
            p = jnp.exp2(s).astype(dt)
        elif variant == "noexp":  # :113-115
            m = jnp.max(s, axis=1, keepdims=True)
            p = (s - m).astype(dt)
        elif variant == "b16exp":  # :116-118
            m = jnp.max(s, axis=1, keepdims=True)
            p = jnp.exp2((s - m).astype(dt))
        else:  # :119-136
            m = jnp.max(s, axis=1, keepdims=True)
            p = jnp.exp2(s - m)
            if variant == "tfull":
                l = jnp.sum(p, axis=1, keepdims=True)
            elif variant == "tb16sum":
                l = jnp.sum(p.astype(dt), axis=1, keepdims=True, dtype=jnp.float32)
            p = p.astype(dt)
            if variant == "tmxusum":
                lcol = jax.lax.dot_general(p, ones_col, dimension_numbers=(((1,), (0,)), ((), ())),
                                           preferred_element_type=jnp.float32)
                l = lcol[:, :1]
        o_full = jax.lax.dot_general(  # :137-141
            p, jnp.concatenate([v[:, hsl], ones_col], axis=1),
            dimension_numbers=(((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
        o = o_full[:, :32]
        if variant in ("tfull", "tmxusum", "tb16sum"):  # :143-146
            o = o / l
        else:
            o = o / o_full[:, 32:]
        outs.append(o.astype(dt))
    return outs[0] if gh == 1 else jnp.concatenate(outs, axis=1)  # :148


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("variant", softmax_variants.VARIANTS)
def test_attention_variant_against_the_tool_body(variant, name, tdtype, jdtype):
    items, n, valid, gh = 2, 128, 120, 2
    q, k, v = softmax_variants.make_qkv(np.random.RandomState(7), items, n, gh,
                                        torch.device("cpu"), tdtype)
    mask, mask_col = softmax_variants.make_masks(n, valid, torch.device("cpu"))
    got = softmax_variants.attention_variant(q, k, v, mask, variant, gh, mask_col)
    assert got.dtype == tdtype and got.shape == q.shape
    want = np.stack([
        np.asarray(_jax_attn_variant(
            _jnp(q[i], jdtype), _jnp(k[i], jdtype), _jnp(v[i], jdtype),
            _jnp(mask, jnp.float32)[None], _jnp(mask_col, jnp.float32)[:, None], gh,
            variant).astype(jnp.float32))
        for i in range(items)])
    assert np.isfinite(want).all()
    assert _rel(_np(got), want) < (F32_REL if tdtype == torch.float32 else BF16_REL)


# variants whose arithmetic is the same by the tool's own code: it folds the
# mask for b16s as for b16sfold (:80), and the PV product's ones column, the
# ones matvec and the sum of the rounded p are one sum of the same numbers
SAME_ARITHMETIC = [{"b16s", "b16sfold"}, {"full", "tmxusum", "tb16sum"}]


def test_variants_are_pairwise_distinguishable():
    """bfloat16, half of the keys under a mask of -1.01 (not a bfloat16 value,
    and small enough to leave them weight): the f32 mask add, the mask as a
    rounded column, the rounded scores, each softmax pass and the three
    denominators all show in the output."""
    items, n, gh = 2, 128, 2
    q, k, v = softmax_variants.make_qkv(np.random.RandomState(11), items, n, gh,
                                        torch.device("cpu"), torch.bfloat16)
    mask = torch.zeros(n)
    mask[n // 2:] = -1.01
    outs = {var: softmax_variants.attention_variant(q * 4, k * 4, v, mask, var, gh)
            for var in softmax_variants.VARIANTS}
    for a, b in itertools.combinations(softmax_variants.VARIANTS, 2):
        if any({a, b} <= group for group in SAME_ARITHMETIC):
            assert _rel(_np(outs[a]), _np(outs[b])) < 1e-2, (a, b)
        else:
            assert not torch.equal(outs[a], outs[b]), (a, b)
    for pair in (("tfull", "tb16sum"), ("full", "kfold")):
        assert not torch.equal(outs[pair[0]], outs[pair[1]])
    with pytest.raises(ValueError, match="variant must be one of"):
        softmax_variants.attention_variant(q, k, v, mask, "softmax", gh)


def _jax_pass(x, op, out_cols):
    """tools/bench_softmax_variants.py:kern (:177-188) on one row block."""
    rb = x.shape[0]
    if op == "exp2":  # :179-180
        return jnp.exp2(x)[:, :out_cols]
    if op == "rowmax":  # :181-184
        return jnp.max(x, axis=1, keepdims=True)[:, :1] * jnp.ones((rb, out_cols), jnp.float32)
    return jnp.sum(x, axis=1, keepdims=True)[:, :1] * jnp.ones((rb, out_cols), jnp.float32)


@pytest.mark.parametrize("op", softmax_variants.PASSES)
def test_softmax_pass_against_the_tool_body(op):
    x = (np.random.RandomState(5).rand(64, 192) * 2 - 1).astype(np.float32)
    got = softmax_variants.softmax_pass(torch.from_numpy(x), op, 128)
    assert got.shape == (64, 128) and got.dtype == torch.float32
    assert _rel(_np(got), _jax_pass(jnp.asarray(x), op, 128)) <= 1e-6
    with pytest.raises(ValueError, match="op must be one of"):
        softmax_variants.softmax_pass(torch.from_numpy(x), "softmax", 128)


# -- the entry points ---------------------------------------------------------------


def test_entry_points_run_on_the_cpu_when_asked(capsys):
    got = fused_freq_ablate.main(["--device", "cpu", "--batch", "1", "--frames", "4", "--reps",
                                  "1"])
    assert set(got) == {(c, s) for c, _ in fused_freq_ablate.SHAPES
                        for s in fused_freq_ablate.STAGES}
    got = flash_ablate.main(["--device", "cpu", "--bh", "2", "--seq", "128", "--block-k", "64",
                             "--reps", "1"])
    assert set(got) == set(flash_ablate.MODES)
    got = softmax_variants.main(["--device", "cpu", "--seq", "64", "--valid", "60",
                                 "--items-scale", "0.01", "--reps", "1"])
    assert len(got) == 2 * len(softmax_variants.VARIANTS) + len(softmax_variants.PASSES)
    out = capsys.readouterr().out
    assert out.count("device: cpu") == 3 and "ms/chunk" in out and "TF/s" in out and "Mel/ms" in out
    assert all(np.isfinite(list(got.values())))


@pytest.mark.parametrize("module", [fused_freq_ablate, flash_ablate, softmax_variants])
def test_entry_points_default_to_the_card(module):
    """Without --device cpu a bench needs CUDA and says so; nothing falls
    back to the plain versions on its own."""
    assert module.get_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run the kernels")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])


def test_wrappers_launch_or_raise_on_a_cuda_tensor():
    """The wrappers take the plain version only for a CPU tensor: a tensor
    on another device goes to the kernel's checks, which raise on what the
    kernel does not take (here before anything is built)."""

    class OnCard:
        def __init__(self, shape, dtype=torch.float32):
            self.shape, self.dtype, self.ndim = torch.Size(shape), dtype, len(shape)
            self.device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="C in"):
        fused_freq_ablate._check_freq("ablate_stage", OnCard((4, 8, 96)))
    q = OnCard((2, 64, 48))
    with pytest.raises(ValueError, match="one shape"):
        softmax_variants.attention_variant(q, q, q, torch.zeros(64), "full", 2)
    with pytest.raises(ValueError, match="float32"):
        softmax_variants.softmax_pass(OnCard((4, 8), torch.bfloat16), "exp2", 4)
    assert functools.reduce(lambda a, fn: a and fn.launches == 0, (
        fused_freq_ablate.ablate_stage, flash_ablate.flash_variant,
        softmax_variants.attention_variant, softmax_variants.softmax_pass), True)
