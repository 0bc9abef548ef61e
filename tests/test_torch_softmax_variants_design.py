"""The design of the tensor-core softmax-variant kernel (B15a,
`beat_this_tpu_torch/csrc/softmax_variants.cu`), checked on the CPU before
the card: the kernel emulated in torch as it takes its steps, for each of
the eleven variants of `bench/softmax_variants.py`:

- keys in 64-key tiles, zeros staged past n and left out of the maximum and
  of p (ragged n);
- two walks where the variant has a row maximum: the first finds each row's
  exact maximum, the second rounds p against it (the plain version's and the
  tool's rounding point); nosmax and nomax one walk;
- the folded mask as one more 16-deep k-step: ones on q's columns 0 .. P - 1,
  the P bf16 parts of round_T(mask) on k's;
- the denominator as a column of ones in the PV product (the sum of p's
  parts), tfull's and tb16sum's own sums;
- float32 operands as P bf16 parts (the products of parts i, j with i + j
  < P, the small terms first), every other step in float32.

The emulation is held to `attention_variant_ref` and to the tool's body
(`tests/test_torch_bench_ablate.py:_jax_attn_variant`) in float32 and
bfloat16, at heads 1, 2 and 4. The parts: three hold every variant a tenth
of the GPU tests' float32 limit (1e-5, `tests/test_torch_cuda_kernels.py:
test_attention_variant`) from float64; two put the variants within 2x of
it and nosmax, whose sums cross zero, far over it; one bf16 product misses
even the 1e-3 of `chip_smoke.py` in every variant with an exp2. In f32
nosmax with no key masked, only the plain version's own FMA chains come
within the GPU test's 1e-5 of it: a tensor-core kernel misses that case.
Tolerance: relative max deviation over the output's largest entry.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beat_this_tpu_torch.bench import softmax_variants as sv
from tests.test_torch_bench_ablate import BF16_REL, F32_REL, _jax_attn_variant

SOURCE = (Path(__file__).resolve().parent.parent / "beat_this_tpu_torch" / "csrc"
          / "softmax_variants.cu")
TILE = 64
F32_PARTS = 3  # csrc/softmax_variants.cu: parts<T>() = mm::full_parts<T>()
GPU_LIMIT, CARD_LIMIT, BF16_LIMIT = 1e-5, 1e-3, 2.5e-2
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The emulation is many small products a key tile: threads add only
    their hand-off, which costs minutes where several test processes share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _parts(x: torch.Tensor, parts: int) -> list:
    """x as `parts` bf16 values: round(x), then what the parts before leave,
    rounded; float64 stays whole."""
    if x.dtype == torch.float64:
        return [x]
    out = []
    for _ in range(parts):
        out.append(_bf16(x))
        x = x - out[-1]
    return out


def _mm(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a @ b from P-part operands: the products of parts i, j with i + j <
    parts, the small terms first (csrc/tc_product.cuh: mm::mma_parts)."""
    if a.dtype == torch.float64:
        return a @ b
    pa, pb = _parts(a, parts), _parts(b, parts)
    small = torch.zeros(a.shape[0], b.shape[1], dtype=a.dtype)
    for t in range(parts - 1, 0, -1):
        for i in range(t, -1, -1):
            small = small + pa[i] @ pb[t - i]
    return small + pa[0] @ pb[0]


def _kernel_head(q, k, v, mask, mask_col, variant, dtype, parts):
    """One (item, head) of the kernel: q, k, v (n, 32) holding values of
    `dtype` (float32 tensors; float64 for the exact reference), the mask and
    the mask column (n,). bf16 operands are one part."""
    exact = q.dtype == torch.float64
    rnd = _bf16 if dtype == torch.bfloat16 else (lambda t: t)
    parts = 1 if dtype == torch.bfloat16 else parts
    n = q.shape[0]
    padded = -(-n // TILE) * TILE
    kp = torch.zeros(padded, 32, dtype=q.dtype)
    vp = torch.zeros(padded, 32, dtype=q.dtype)
    kp[:n], vp[:n] = k, v
    keys = torch.arange(padded)
    inside = keys < n
    mask_p = torch.zeros(padded, dtype=q.dtype)
    col_p = torch.zeros(padded, dtype=q.dtype)
    mask_p[:n], col_p[:n] = mask, rnd(mask_col)

    def tile_scores(k0, ps):
        s = _mm(q, kp[k0:k0 + TILE].T, ps)
        if variant in sv.FOLDED:  # one more k-step: 1 * each part of round_T(mask)
            s = s + sum(_parts(col_p[k0:k0 + TILE], ps))
        else:
            s = s + mask_p[k0:k0 + TILE]
        if variant in ("b16s", "b16sfold"):
            s = rnd(s)
        return s

    m = None
    if variant not in ("nosmax", "nomax"):  # walk 1
        first = parts if variant == "noexp" or exact else 1
        m = torch.full((n, 1), -torch.inf, dtype=q.dtype)
        for k0 in range(0, padded, TILE):
            s = tile_scores(k0, first).masked_fill(~inside[k0:k0 + TILE], -torch.inf)
            m = torch.maximum(m, s.amax(-1, keepdim=True))
    acc = torch.zeros(n, 32, dtype=q.dtype)
    den = torch.zeros(n, 1, dtype=q.dtype)
    own = torch.zeros(n, 1, dtype=q.dtype)
    for k0 in range(0, padded, TILE):  # walk 2
        s = tile_scores(k0, parts)
        p = {"nosmax": lambda: s, "nomax": lambda: torch.exp2(s), "noexp": lambda: s - m,
             "b16exp": lambda: torch.exp2(rnd(s - m))}.get(variant, lambda: torch.exp2(s - m))()
        p = p.masked_fill(~inside[k0:k0 + TILE], 0.0)
        if variant == "tfull":
            own = own + p.sum(-1, keepdim=True)
        elif variant == "tb16sum":
            own = own + rnd(p).sum(-1, keepdim=True)
        p = rnd(p)  # bf16: the A fragments of P V are round_T(p)
        acc = acc + _mm(p, vp[k0:k0 + TILE], parts)
        den = den + sum(_parts(p, parts)).sum(-1, keepdim=True)  # the ones column
    return acc / (own if variant in ("tfull", "tb16sum") else den)


def emulate(q, k, v, mask, mask_col, variant, heads, parts=F32_PARTS, exact=False):
    """The kernel over (items, n, heads * 32) q, k, v; `exact`: in float64,
    nothing rounded (the values of q, k, v as given)."""
    dtype = q.dtype
    wide = torch.float64 if exact else torch.float32
    out = torch.empty(q.shape, dtype=wide)
    for i in range(q.shape[0]):
        for h in range(heads):
            cols = slice(32 * h, 32 * h + 32)
            out[i, :, cols] = _kernel_head(
                q[i, :, cols].to(wide), k[i, :, cols].to(wide), v[i, :, cols].to(wide),
                mask.to(wide), mask_col.to(wide), variant, dtype, parts)
    return out if exact else out.to(dtype)


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _case(items, n, valid, heads, dtype, seed):
    q, k, v = sv.make_qkv(np.random.RandomState(seed), items, n, heads, CPU, dtype)
    return (q, k, v, *sv.make_masks(n, valid, CPU))


@pytest.mark.parametrize("dtype,limit", [(torch.float32, GPU_LIMIT), (torch.bfloat16, BF16_LIMIT)])
@pytest.mark.parametrize("variant", sv.VARIANTS)
def test_emulation_matches_the_plain_version_and_the_tool(variant, dtype, limit):
    """Ragged n (200: a last tile of 8 keys), 30 keys masked, heads 1, 2, 4."""
    for items, heads in ((2, 1), (1, 2), (1, 4)):
        q, k, v, mask, mask_col = _case(items, 200, 170, heads, dtype, 3 * heads)
        got = emulate(q, k, v, mask, mask_col, variant, heads)
        assert _rel(got, sv.attention_variant_ref(q, k, v, mask, variant, heads, mask_col)) < limit
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        tool = np.stack([np.asarray(_jax_attn_variant(
            jnp.asarray(q[i].float().numpy()).astype(jdt),
            jnp.asarray(k[i].float().numpy()).astype(jdt),
            jnp.asarray(v[i].float().numpy()).astype(jdt),
            jnp.asarray(mask.numpy())[None], jnp.asarray(mask_col.numpy())[:, None], heads,
            variant).astype(jnp.float32)) for i in range(items)])
        assert _rel(got.float(), torch.from_numpy(tool)) < (
            F32_REL if dtype == torch.float32 else BF16_REL)


def _f32_errors(parts, cases):
    """Per variant, the largest relative deviation of the float32 emulation
    at `parts` from float64 over the cases."""
    errs = dict.fromkeys(sv.VARIANTS, 0.0)
    for case in cases:
        q, k, v, mask, mask_col = _case(*case, torch.float32, sum(case))
        heads = case[3]
        for var in sv.VARIANTS:
            want = emulate(q, k, v, mask, mask_col, var, heads, exact=True)
            got = emulate(q, k, v, mask, mask_col, var, heads, parts)
            errs[var] = max(errs[var], _rel(got, want))
    return errs


# (items, n, valid, heads): the GPU tests' first two shapes
GPU_CASES = ((3, 200, 170, 2), (2, 128, 128, 1))


def test_three_parts_hold_every_variant():
    errs = _f32_errors(F32_PARTS, GPU_CASES)
    worst = {var: err for var, err in errs.items() if err >= GPU_LIMIT / 10}
    # nosmax over the unmasked keys divides by a sum of scores that crosses
    # zero: there the float32 plain version is as far from float64 (below)
    assert set(worst) <= {"nosmax"}, worst


def test_fewer_parts_miss_the_limits():
    two = _f32_errors(2, GPU_CASES)
    assert max(two.values()) > GPU_LIMIT / 2, two
    assert two["nosmax"] > 10 * GPU_LIMIT, two
    one = _f32_errors(1, GPU_CASES[:1])
    assert all(err > CARD_LIMIT for var, err in one.items() if var not in ("nosmax", "noexp")), one


def test_cancelling_nosmax_is_as_close_as_float32_allows():
    """Unmasked nosmax: o = sum(s v) / sum(s), with rows whose sum of scores
    is a hundredth of its terms' sizes; three parts put o as far from
    float64 as the float32 plain version is, within a few times."""
    q, k, v, mask, mask_col = _case(2, 128, 128, 1, torch.float32, 129)
    want = emulate(q, k, v, mask, mask_col, "nosmax", 1, exact=True)
    plain = _rel(sv.attention_variant_ref(q, k, v, mask, "nosmax", 1, mask_col), want)
    assert plain > GPU_LIMIT  # the float32 plain version's own distance
    assert _rel(emulate(q, k, v, mask, mask_col, "nosmax", 1), want) < 5 * plain


def _f32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32).astype(np.float64)


def _nosmax_chains(q: np.ndarray, k: np.ndarray, v: np.ndarray, s=None):
    """nosmax over unmasked keys as float32 FMA chains, each product of two
    float32 values exact in float64 and every sum rounded: s = q k^T over
    the 32 columns in order (unless given), o = s [v, 1] over the keys in
    order (the plain version's products, `torch.matmul` in float32)."""
    if s is None:
        s = np.zeros((q.shape[0], k.shape[0]))
        for d in range(q.shape[1]):
            s = _f32(np.outer(q[:, d], k[:, d]) + s)
    num, den = np.zeros((q.shape[0], v.shape[1])), np.zeros(q.shape[0])
    for j in range(k.shape[0]):
        num, den = _f32(np.outer(s[:, j], v[j]) + num), _f32(s[:, j] + den)
    return _f32(num / den[:, None])


def test_cancelling_nosmax_needs_the_plain_versions_chains():
    """The GPU test's unmasked f32 nosmax case (`test_attention_variant`,
    (2, 128, 128, 1)) holds the kernel to the plain version within 1e-5, and
    there the plain version's own rounding is 1.9e-5 of float64: only its
    float32 FMA chains (s over the columns, the sums over the keys, in
    order) come within the limit; the exact answer, and correctly rounded s
    summed in the plain version's order, do not."""
    q, k, v, mask, mask_col = _case(2, 128, 128, 1, torch.float32, 129)
    plain = sv.attention_variant_ref(q, k, v, mask, "nosmax", 1, mask_col)
    qs, ks, vs = (t.double().numpy() for t in (q, k, v))
    chains = np.stack([_nosmax_chains(qs[i], ks[i], vs[i]) for i in range(2)])
    exact = np.stack([(qs[i] @ ks[i].T) @ vs[i] / (qs[i] @ ks[i].T).sum(1, keepdims=True)
                      for i in range(2)])
    rounded_s = np.stack([_nosmax_chains(qs[i], ks[i], vs[i], _f32(qs[i] @ ks[i].T))
                          for i in range(2)])
    assert _rel(torch.from_numpy(chains), plain) < GPU_LIMIT / 10
    assert _rel(torch.from_numpy(exact), plain) > GPU_LIMIT
    assert _rel(torch.from_numpy(rounded_s), plain) > GPU_LIMIT


def test_fold_adds_the_rounded_mask_exactly():
    """The fold's k-step over P parts adds round_T(mask) itself: the parts of
    a float32 value sum to it, and the tool's -98304 is one bf16 part."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32) * 1e5)
    assert torch.equal(sum(_parts(x, F32_PARTS)), x)
    assert torch.equal(_parts(torch.tensor([-98304.0]), 1)[0], torch.tensor([-98304.0]))


def test_kernel_source_takes_the_chosen_parts():
    text = SOURCE.read_text()
    assert re.search(r"constexpr int parts\(\) \{ return mm::full_parts<T>\(\); \}", text)
    assert "V == kNoExp ? parts<T>() : 1" in text  # walk 1 exact where p is linear in m
