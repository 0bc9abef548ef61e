"""The CUDA kernels against their plain PyTorch versions on the card, at
small and ragged shapes the main path does not reach: row counts that are
not a multiple of the 32-row tile, sequence lengths that are not a multiple
of the attention tiles, every supported width; the training kernels with
dropout off and on (the same Philox masks on both sides), output and every
gradient, also at the frontend's widths over enough rows that the
weight-gradient launches take more than two row-tile groups, and the
feed-forward backward at C 512 over ragged rows split into several row
groups; the attention kernels on (entries, seq, head_dim) at ragged
lengths, head widths 16 and 32, with and without rotation tables, output
and dq, dk, dv. Needs a CUDA device and nvcc; skips without one. Run on
the GPU machine with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

(the repository's conftest.py imports JAX, which that machine lacks).
Tolerances: float32 relative max deviation 1e-5 (TF32 off; the eval
kernels' float32 products, three bf16 products of two-part operands, hold
about 4e-6: tests/test_torch_eval_tc_design.py), 1e-4 for the training
kernels' gradients (sums
over every row, in another order; the float32 products of the feed-forward
backward and of the attention branch's forward and backward, three bf16
products of split operands each, hold about 1e-5; those of the
feed-forward forward and of the frequency block's backward, six products
of three-part operands, about 1e-6; the flash forward's six products hold
its forward modes within 1e-5 and its backward's three its gradients
within 1e-4: tests/test_torch_flash_f32_design.py), bfloat16 < 2.5e-2 (the
two sides round intermediates to bfloat16 at different places). The masks
of the feed-forward forward, the frequency block's backward and the flash
forward are read off their outputs and held to the plain version's bit for
bit. The ablation kernels of
`beat_this_tpu_torch/bench/` (every stage, mode, variant and pass) and the
DBN decoder on the card against the CPU are held here too."""

import hashlib

import numpy as np
import pytest
import torch

from beat_this_tpu_torch.model.layers import Attention, FeedForward
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops import flash_attention as flash_ops
from beat_this_tpu_torch.ops import fused_ff as ff_ops
from beat_this_tpu_torch.ops import fused_freq as freq_ops
from beat_this_tpu_torch.ops import fused_time as time_ops
from beat_this_tpu_torch.ops import small_attention as small_ops
from beat_this_tpu_torch.ops.fused_ff import fused_ff, fused_ff_ref
from beat_this_tpu_torch.ops.fused_freq import fused_freq_roformer, fused_freq_roformer_ref
from beat_this_tpu_torch.ops.fused_time import fused_time_roformer, fused_time_roformer_ref
from beat_this_tpu_torch.ops.rotary import rope_tables

pytestmark = pytest.mark.gpu

DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 2.5e-2)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _block(c, heads, seed, device):
    rng = np.random.default_rng(seed)
    attn, ff = Attention(c, heads), FeedForward(c)
    with torch.no_grad():
        for p in list(attn.parameters()) + list(ff.parameters()):
            fan_in = p.shape[-1] if p.ndim == 2 else 1
            scale = 1 / np.sqrt(fan_in) if p.ndim == 2 else 0.1
            p.copy_(torch.from_numpy((scale * rng.standard_normal(p.shape)).astype(np.float32)))
        attn.norm.gamma.add_(1.0)
        ff.net[0].gamma.add_(1.0)
    return attn.to(device).requires_grad_(False), ff.to(device).requires_grad_(False)


def _x(shape, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _rel64(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("c", [32, 64, 128, 256, 384, 512])
def test_fused_ff(device, dtype, tol, c):
    _, ff = _block(c, c // 32, c, device)
    x = _x((2, 45, c), dtype, device, c)
    before = fused_ff.launches
    got = fused_ff(x, ff)
    assert fused_ff.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, fused_ff_ref(x, ff)) < tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("heads,n,items", [(1, 77, 3), (2, 130, 2), (4, 64, 1), (16, 200, 1),
                                           (8, 150, 1), (12, 90, 2)])
def test_fused_time(device, dtype, tol, heads, n, items):
    c = heads * 32
    attn, ff = _block(c, heads, n, device)
    cos, sin = rope_tables(n, 32, device)
    x = _x((items, n, c), dtype, device, n)
    got = fused_time_roformer(x, attn, ff, cos, sin, heads)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, fused_time_roformer_ref(x, attn, ff, cos, sin, heads)) < tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("f,c,items", [(32, 32, 5), (16, 64, 7), (8, 128, 37), (4, 64, 9),
                                       (32, 32, 133), (16, 64, 77), (8, 128, 301), (2, 32, 21),
                                       (1, 128, 45)])
def test_fused_freq(device, dtype, tol, f, c, items):
    """K3 at the three frequency shapes and every F dividing 32, over item
    counts whose rows end in a partial 128-row tile."""
    attn, ff = _block(c, c // 32, f * c, device)
    cos, sin = rope_tables(f, 32, device)
    x = _x((items, f, c), dtype, device, f)
    before = fused_freq_roformer.launches
    got = fused_freq_roformer(x, attn, ff, cos, sin)
    assert fused_freq_roformer.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, fused_freq_roformer_ref(x, attn, ff, cos, sin)) < tol


def _freq_digest(kind: str, dtype, f: int, c: int, items: int, device) -> str:
    """sha256 of the bytes of K3's output (kind "eval") or B6's (kind
    "train", rate 0.2, seed 19) on seeded inputs."""
    attn, ff = _block(c, c // 32, 7 * c + f, device)
    cos, sin = rope_tables(f, 32, device)
    x = _x((items, f, c), dtype, device, 3 * f + items)
    with torch.no_grad():
        if kind == "eval":
            out = fused_freq_roformer(x, attn, ff, cos, sin)
        else:
            out = freq_ops.fused_freq_roformer_train(x, attn, ff, cos, sin, 0.2, 19)
    return hashlib.sha256(out.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


# K3's and B6's outputs on the card, taken from freq_block_kernel before the
# packed score tile's helpers moved into csrc/small_tile.cuh (sm_90a, nvcc
# 12.9): the move keeps every bit. (kind, dtype, F, C, items) -> sha256
FREQ_CASES = [(kind, dtype, f, c, items) for kind, shapes in (
    ("eval", ((32, 32, 133), (8, 128, 301), (2, 32, 21))),
    ("train", ((16, 64, 77), (4, 64, 9), (1, 128, 45))))
    for f, c, items in shapes for dtype in ("float32", "bfloat16")]
FREQ_DIGESTS = {
    ("eval", "float32", 32, 32, 133):
        "31a6eb3eff0b4e91872b32bcb2873bc95bd9d468ef229e1e8f56591ab0777e5c",
    ("eval", "bfloat16", 32, 32, 133):
        "d6fef274a6cf9e5a06c0847ffdac53f057806c5e9f0400f7f3a3d7d8f54ee908",
    ("eval", "float32", 8, 128, 301):
        "3f4523f0bffb4f4931db24837f0d4d1d78cf740df8d511b6b1116695b3609b1c",
    ("eval", "bfloat16", 8, 128, 301):
        "fd399b823fcb06223bb797cba48d4d6df633f68cd2485cf5e59650633bdd35c5",
    ("eval", "float32", 2, 32, 21):
        "6b87b06a61b9794e5a9f89f48f8d8bc9417429e7765d7865ace088e651b9d45d",
    ("eval", "bfloat16", 2, 32, 21):
        "5e8269b3bc86462f0e8a6b0319bcdea18cc5e796813090c600e0306c4aab35f6",
    ("train", "float32", 16, 64, 77):
        "61e6ac23250d8f87f59e66a9767cde323389a77518409452eb0f2276b8aaf57a",
    ("train", "bfloat16", 16, 64, 77):
        "506938162ce0248bef390cef97ff223f82853c2c5ed0d7b6c249e2e7b8b964ca",
    ("train", "float32", 4, 64, 9):
        "95e025a8f9334750f89fba15fda8e3aeac4ef10efa7276bee8219e8109d2b0cf",
    ("train", "bfloat16", 4, 64, 9):
        "8b078d0180ce2f035145c62f2adfa9f129fe0b3ef57c296124fa6a2c1c241343",
    ("train", "float32", 1, 128, 45):
        "805e5f61a7c6f3c75d40c2c90347384f970e5a0186ae976699f89bacb391ffab",
    ("train", "bfloat16", 1, 128, 45):
        "7e0264d1d1824a9da4df8c9ac3041567a037fb71405e61da7fc11ee87877dcbe",
}


@pytest.mark.parametrize("case", FREQ_CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_freq_keeps_its_bits(device, case):
    kind, dtype, f, c, items = case
    assert _freq_digest(kind, getattr(torch, dtype), f, c, items, device) == FREQ_DIGESTS[case]


def test_unsupported_width_raises(device):
    _, ff = _block(96, 3, 0, device)
    with pytest.raises(ValueError, match="supports C"):
        fused_ff(torch.zeros((4, 96), device=device), ff)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("c", [32, 64, 128, 256, 384, 512])
@pytest.mark.parametrize("rows", [601, 768])
def test_fused_ff_tensor_core_tiles(device, dtype, tol, c, rows):
    """K1 on the tensor cores at the masked short piece's rows: 601 valid
    frames (not a multiple of the 128-row tile) and its 768-frame bucket, at
    every width; four launches a call, counted once."""
    _, ff = _block(c, c // 32, c + rows, device)
    x = _x((1, rows, c), dtype, device, rows)
    before = fused_ff.launches
    got = fused_ff(x, ff)
    assert fused_ff.launches == before + 1
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got, fused_ff_ref(x, ff)) < tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("c", [32, 64, 128, 256, 384, 512])
@pytest.mark.parametrize("n,items", [(1500, 1), (601, 2)])
def test_fused_time_tensor_core_tiles(device, dtype, tol, c, n, items):
    """K2 on the tensor cores at every width (C / 32 heads) over a chunk's
    1500 frames and a 601-frame piece: lengths that are not multiples of the
    64-key tiles, rows that are not multiples of the 128-row tiles."""
    heads = c // 32
    attn, ff = _block(c, heads, c + n, device)
    cos, sin = rope_tables(n, 32, device)
    x = _x((items, n, c), dtype, device, n + c)
    before = fused_time_roformer.launches
    got = fused_time_roformer(x, attn, ff, cos, sin, heads)
    assert fused_time_roformer.launches == before + 1
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got, fused_time_roformer_ref(x, attn, ff, cos, sin, heads)) < tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_fused_time_at_a_chunk_batch(device, dtype, tol):
    """K2 at a main layer over a whole forward batch of the chunked
    predictor: 16 chunks of 1500 frames at C 512, 16 heads
    (inference.py:CHUNK_BATCH; a long piece or a directory batch)."""
    c, heads, n, items = 512, 16, 1500, 16
    attn, ff = _block(c, heads, 16, device)
    cos, sin = rope_tables(n, 32, device)
    x = _x((items, n, c), dtype, device, 16)
    got = fused_time_roformer(x, attn, ff, cos, sin, heads)
    assert _rel(got, fused_time_roformer_ref(x, attn, ff, cos, sin, heads)) < tol


@pytest.mark.parametrize("dtype,parts", [(torch.float32, 2), (torch.bfloat16, 1)])
def test_eval_scratch_holds_the_operands(device, dtype, parts):
    """K1's and K2's scratch as the library lays it out, at 2 x 1500 rows of
    C 512: at least K1's operands (g and the hidden layer, 5 C bf16 values a
    row in P parts) and K2's (those, q, k, v and the gated output, 9 C, and
    the float32 y1); and each kernel refuses a scratch one byte short."""
    import ctypes

    items, n, c, heads = 2, 1500, 512, 16
    rows, m, code = items * n, 4 * c, ff_ops.dtype_code(dtype)
    lib = ff_ops._build.load_library()
    ff_bytes, time_bytes = ctypes.c_longlong(), ctypes.c_longlong()
    assert lib.bt_fused_ff_scratch(code, c, rows, m, ctypes.byref(ff_bytes)) == 0
    assert lib.bt_fused_time_scratch(code, c, rows, m, ctypes.byref(time_bytes)) == 0
    assert parts * 5 * rows * c * 2 < ff_bytes.value < 2e8
    assert parts * 9 * rows * c * 2 + rows * c * 4 < time_bytes.value < 3e8
    assert lib.bt_fused_time_scratch(code, 96, rows, m, ctypes.byref(time_bytes)) != 0
    assert lib.bt_fused_time_scratch(code, c, rows, m, ctypes.byref(time_bytes)) == 0
    attn, ff = _block(c, heads, 2, device)
    cos, sin = rope_tables(n, 32, device)
    x = _x((items, n, c), dtype, device, 3)
    out = torch.empty_like(x)
    ffp = ff_ops.ff_params(ff, torch.float32)
    params = time_ops.block_params(attn, ff, torch.float32)
    scratch = torch.empty(max(ff_bytes.value, time_bytes.value), dtype=torch.uint8,
                          device=device)

    def launch_ff(size):
        return lib.bt_fused_ff(code, c, x.data_ptr(), *(p.data_ptr() for p in ffp),
                               out.data_ptr(), scratch.data_ptr(), size, rows, m,
                               ff_ops.stream_of(x))

    def launch_time(size):
        return lib.bt_fused_time(code, c, x.data_ptr(), *(p.data_ptr() for p in params),
                                 cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
                                 scratch.data_ptr(), size, items, n, m, ff_ops.stream_of(x))

    assert launch_ff(ff_bytes.value - 1) != 0
    assert launch_ff(ff_bytes.value) == 0
    assert launch_time(time_bytes.value - 1) != 0
    assert launch_time(time_bytes.value) == 0
    torch.cuda.synchronize()


TRAIN_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2.5e-2)]


def _run_grads(fn, x, params, cot):
    """Output and the gradients of sum(out * cot) w.r.t. x and `params`."""
    for p in params:
        p.grad = None
    x = x.detach().clone().requires_grad_(True)
    out = fn(x)
    (out.float() * cot).sum().backward()
    return [out.detach()] + [x.grad] + [p.grad.clone() for p in params]


def _compare_train(kernel, plain, x, params, tol, seed):
    cot = _x(x.shape, torch.float32, x.device, seed + 1)
    got = _run_grads(kernel, x, params, cot)
    want = _run_grads(plain, x, params, cot)
    for i, (g, w) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g.float()).all()), i
        assert _rel(g, w) < tol, (i, _rel(g, w))
    return got


@pytest.mark.parametrize("dtype,tol", TRAIN_DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("c,rows", [(32, 45), (64, 100), (128, 77), (512, 70), (256, 90),
                                    (384, 300)])
def test_fused_ff_train(device, dtype, tol, rate, c, rows):
    _, ff = _block(c, c // 32, c + rows, device)
    ff.requires_grad_(True)
    x = _x((rows, c), dtype, device, c)
    before = (ff_ops.ff_train_fwd.launches, ff_ops.ff_train_bwd.launches)
    _compare_train(lambda t: ff_ops.fused_ff_train(t, ff, rate, 7),
                   lambda t: ff_ops.fused_ff_train_ref(t, ff, rate, 7),
                   x, list(ff.parameters()), tol, c)
    assert (ff_ops.ff_train_fwd.launches, ff_ops.ff_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)


def _ff_wgrad_groups(rows, c, dtype):
    """Row groups of B9's weight-gradient products at this shape."""
    group_rows, _ = ff_ops.ff_bwd_plan(rows, c, 4 * c, dtype)
    return -(-rows // group_rows)


@pytest.mark.parametrize("dtype,tol", TRAIN_DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("rows", [1000, 1537])
def test_fused_ff_train_row_groups(device, dtype, tol, rate, rows):
    """B9 at C 512 over ragged rows that its weight-gradient products split
    into several row groups (the last one short), one launch each way."""
    c = 512
    assert _ff_wgrad_groups(rows, c, dtype) > 2
    _, ff = _block(c, c // 32, rows, device)
    ff.requires_grad_(True)
    x = _x((rows, c), dtype, device, rows)
    before = (ff_ops.ff_train_fwd.launches, ff_ops.ff_train_bwd.launches)
    _compare_train(lambda t: ff_ops.fused_ff_train(t, ff, rate, 8),
                   lambda t: ff_ops.fused_ff_train_ref(t, ff, rate, 8),
                   x, list(ff.parameters()), tol, rows)
    assert (ff_ops.ff_train_fwd.launches, ff_ops.ff_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype,parts,limit", [(torch.float32, 2, 4e8),
                                                (torch.bfloat16, 1, 2.5e8)])
def test_ff_bwd_scratch_holds_the_stash(device, dtype, parts, limit):
    """B9's scratch at the main shape (12000 rows, C 512) as the library
    lays it out: at least the stash d_pre1 and h1d (12000 x 2048 bf16
    values each, hi and lo parts in float32), under `limit` bytes in all;
    and the kernel refuses a scratch one byte short."""
    rows, c = 12000, 512
    group_rows, nbytes = ff_ops.ff_bwd_plan(rows, c, 4 * c, dtype)
    assert parts * 2 * rows * 4 * c * 2 < nbytes < limit
    _, ff = _block(c, c // 32, rows, device)
    gamma, w1, b1, w2 = (p.detach().to(t).contiguous() for p, t in zip(
        ff.parameters(), (torch.float32, dtype, torch.float32, dtype)))
    x, dout = _x((rows, c), dtype, device, 1), _x((rows, c), dtype, device, 2)
    dx = torch.empty_like(x)
    grads = [torch.empty(shape, dtype=torch.float32, device=device)
             for shape in ((c,), (4 * c, c), (4 * c,), (c, 4 * c), (c,))]
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)
    lib = ff_ops._build.load_library()

    def launch(size):
        return lib.bt_ff_train_bwd(
            ff_ops.dtype_code(dtype), ff_ops.dtype_code(dtype), c, x.data_ptr(),
            gamma.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dout.data_ptr(),
            dx.data_ptr(), *(g.data_ptr() for g in grads), scratch.data_ptr(), size, rows,
            4 * c, group_rows, 0, 0, 0, 1.0, 0, 0, 0, ff_ops.stream_of(x))

    assert launch(nbytes - 1) != 0
    assert launch(nbytes) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,tol", TRAIN_DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("heads,n,items", [(1, 77, 3), (2, 130, 2), (4, 64, 1), (16, 200, 1),
                                           (8, 150, 1), (12, 90, 2)])
def test_fused_time_attention_train(device, dtype, tol, rate, heads, n, items):
    c = heads * 32
    attn, _ = _block(c, heads, n, device)
    attn.requires_grad_(True)
    cos, sin = rope_tables(n, 32, device)
    x = _x((items, n, c), dtype, device, n)
    before = (time_ops.attn_train_fwd.launches, time_ops.attn_train_bwd.launches)
    _compare_train(
        lambda t: time_ops.fused_time_attention_train(t, attn, cos, sin, heads, rate, 11),
        lambda t: time_ops.fused_time_attention_train_ref(t, attn, cos, sin, heads, rate, 11),
        x, list(attn.parameters()), tol, n)
    assert (time_ops.attn_train_fwd.launches, time_ops.attn_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype,tol", TRAIN_DTYPES)
@pytest.mark.parametrize("heads,n,items", [(1, 77, 3), (1, 1500, 2), (16, 1500, 1), (2, 64, 3),
                                           (1, 17000, 1)])
def test_fused_time_attention_train_tensor_core_tiles(device, dtype, tol, heads, n, items):
    """B4/B5 on the tensor cores at lengths that are not multiples of the
    64-row tiles (n 77, 1500), one 64-key block (n 64), and more key blocks
    than one launch of B5's fused pass takes (n 17000: 266 blocks of an
    (item, head), over half of what the card holds at 4 blocks an SM), one
    head at C 32, 2 at C 64, 16 at C 512, dropout 0.2: output, dx and the
    five parameter gradients."""
    c = heads * 32
    attn, _ = _block(c, heads, n + heads, device)
    attn.requires_grad_(True)
    cos, sin = rope_tables(n, 32, device)
    x = _x((items, n, c), dtype, device, n + 1)
    _compare_train(
        lambda t: time_ops.fused_time_attention_train(t, attn, cos, sin, heads, 0.2, 12),
        lambda t: time_ops.fused_time_attention_train_ref(t, attn, cos, sin, heads, 0.2, 12),
        x, list(attn.parameters()), tol, n + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,heads,n,items,rate", [(128, 4, 333, 8, 0.2), (512, 16, 1500, 8, 0.2),
                                                  (32, 1, 1500, 256, 0.1)])
def test_attention_train_backward_is_deterministic(device, dtype, c, heads, n, items, rate):
    """Two B5 backwards on the same inputs give the same bits in both
    dtypes (row-group partials and the fused pass's dQ shares summed in a
    fixed order, no float atomics), over enough rows for several
    weight-gradient groups; at the main shape (16 heads, 8 items) and the
    frontend's (1 head at C 32, 256 items) the fused pass's blocks span
    several waves."""
    assert -(-items * n // time_ops.attn_bwd_plan(items * n, c, dtype)[0]) > 2
    attn, _ = _block(c, heads, 7, device)
    attn.requires_grad_(True)
    cos, sin = rope_tables(n, 32, device)
    x = _x((items, n, c), dtype, device, 8)

    def fn(t):
        return time_ops.fused_time_attention_train(t, attn, cos, sin, heads, rate, 9)

    cot = _x(x.shape, torch.float32, device, 10)
    first = _run_grads(fn, x, list(attn.parameters()), cot)
    second = _run_grads(fn, x, list(attn.parameters()), cot)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attn_wgrad_tiles(device):
    """The output tiles per row group of B5's weight-gradient launch, as
    tests/test_torch_attn_train_design.py takes them (WGRAD_TILES)."""
    import ctypes

    lib = ff_ops._build.load_library()
    got = {}
    for c in (32, 64, 128, 256, 384, 512):
        tiles = ctypes.c_int()
        assert lib.bt_attn_wgrad_tiles(c, ctypes.byref(tiles)) == 0
        got[c] = tiles.value
    assert got == {32: 2, 64: 3, 128: 4, 256: 16, 384: 36, 512: 64}
    assert lib.bt_attn_wgrad_tiles(96, ctypes.byref(ctypes.c_int())) != 0


@pytest.mark.parametrize("dtype,parts", [(torch.float32, 2), (torch.bfloat16, 1)])
def test_attn_bwd_scratch_holds_the_operands(device, dtype, parts):
    """B5's scratch at the main shape (8 x 1500 rows, C 512) as the library
    lays it out: at least its operands (d_branch, the gated rows, dO / l, g
    and d_q | d_k | d_v: 7 C bf16 values a row, hi and lo parts in float32)
    and the float32 d_gn, under 0.4 GB in all; and the kernel refuses a
    scratch one byte short."""
    items, n, c, heads = 8, 1500, 512, 16
    rows = items * n
    group_rows, nbytes = time_ops.attn_bwd_plan(rows, c, dtype)
    assert parts * 7 * rows * c * 2 + rows * c * 4 < nbytes < 4e8
    attn, _ = _block(c, heads, 1, device)
    cos, sin = rope_tables(n, 32, device)
    x = _x((items, n, c), dtype, device, 1)
    params = [time_ops.f32(attn.norm.gamma), time_ops.kernel_weight(attn.to_qkv.weight, dtype),
              time_ops.f32(attn.to_gates.weight), time_ops.f32(attn.to_gates.bias),
              time_ops.kernel_weight(attn.to_out[0].weight, dtype), cos, sin]
    _, saved = time_ops.attn_train_fwd(x, *params, heads, 0.0, None)
    dout = _x((items, n, c), dtype, device, 2)
    dx = torch.empty_like(x)
    grads = [torch.empty(shape, dtype=torch.float32, device=device)
             for shape in ((c,), (4 * c, c), (heads, c), (heads,))]
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)
    lib = ff_ops._build.load_library()
    bwd_params = params[:3] + params[4:]

    def launch(size):
        return lib.bt_attn_train_bwd(
            ff_ops.dtype_code(dtype), c, x.data_ptr(), *(p.data_ptr() for p in bwd_params),
            *(t.data_ptr() for t in saved), dout.data_ptr(), dx.data_ptr(),
            *(g.data_ptr() for g in grads), scratch.data_ptr(), size, items, n, group_rows,
            0, 0, 0, 1.0, 0, 0, 0, ff_ops.stream_of(x))

    assert launch(nbytes - 1) != 0
    assert launch(nbytes) == 0
    torch.cuda.synchronize()


def test_training_backward_is_deterministic(device):
    """Two backward runs give the same bits (no float atomics)."""
    attn, ff = _block(128, 4, 3, device)
    attn.requires_grad_(True)
    ff.requires_grad_(True)
    cos, sin = rope_tables(96, 32, device)
    x = _x((3, 96, 128), torch.float32, device, 5)

    def fn(t):
        h = t + time_ops.fused_time_attention_train(t, attn, cos, sin, 4, 0.2, 3)
        return ff_ops.fused_ff_train(h, ff, 0.2, 4)

    params = list(attn.parameters()) + list(ff.parameters())
    cot = _x(x.shape, torch.float32, device, 6)
    first, second = _run_grads(fn, x, params, cot), _run_grads(fn, x, params, cot)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", TRAIN_DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("f,c,items", [(32, 32, 5), (16, 64, 7), (8, 128, 37), (4, 64, 9),
                                       (2, 32, 21), (1, 128, 45), (32, 32, 133), (16, 64, 77),
                                       (8, 128, 301)])
def test_fused_freq_train(device, dtype, tol, rate, f, c, items):
    """B6 and B7 against fused_freq_roformer_train_ref: output, dx and the
    ten parameter gradients, every F dividing 32, ragged row tiles."""
    _check_freq_train(device, dtype, tol, rate, f, c, items)


@pytest.mark.parametrize("dtype,tol", TRAIN_DTYPES)
@pytest.mark.parametrize("f,c,items", [(32, 32, 12000), (16, 64, 12000), (8, 128, 12000)])
def test_fused_freq_train_at_the_stock_shapes(device, dtype, tol, f, c, items):
    """The same at the stock frontend's three frequency blocks: 8 crops of
    1500 frames, dropout 0.1."""
    _check_freq_train(device, dtype, tol, 0.1, f, c, items)


def _check_freq_train(device, dtype, tol, rate, f, c, items):
    attn, ff = _block(c, c // 32, f * c + items, device)
    attn.requires_grad_(True)
    ff.requires_grad_(True)
    cos, sin = rope_tables(f, 32, device)
    x = _x((items, f, c), dtype, device, f + items)
    before = (freq_ops.freq_train_fwd.launches, freq_ops.freq_train_bwd.launches)
    _compare_train(
        lambda t: freq_ops.fused_freq_roformer_train(t, attn, ff, cos, sin, rate, 13),
        lambda t: freq_ops.fused_freq_roformer_train_ref(t, attn, ff, cos, sin, rate, 13),
        x, list(attn.parameters()) + list(ff.parameters()), tol, f + c)
    assert (freq_ops.freq_train_fwd.launches, freq_ops.freq_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)


def test_fused_freq_train_backward_is_deterministic(device):
    """Two backward runs of B7 give the same bits (grouped partials summed
    in a fixed order, no float atomics)."""
    attn, ff = _block(64, 2, 8, device)
    attn.requires_grad_(True)
    ff.requires_grad_(True)
    cos, sin = rope_tables(16, 32, device)
    x = _x((300, 16, 64), torch.float32, device, 9)

    def fn(t):
        return freq_ops.fused_freq_roformer_train(t, attn, ff, cos, sin, 0.1, 21)

    params = list(attn.parameters()) + list(ff.parameters())
    cot = _x(x.shape, torch.float32, device, 10)
    first, second = _run_grads(fn, x, params, cot), _run_grads(fn, x, params, cot)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("c,rows", [(32, 300), (128, 77), (512, 70)])
def test_ff_train_backward_on_float32_rows(device, rate, c, rows):
    """B9 on float32 rows with bfloat16 compute, as B7 runs its FF half on
    the residual x2, against the backward of `ff_train_branch` with those
    rounding points: dx (float32) and the five parameter gradients."""
    _, ff = _block(c, c // 32, c + rows, device)
    ff.requires_grad_(True)
    norm, lin1, _, _, lin2, _ = ff.net
    x = _x((rows, c), torch.float32, device, c)
    dout = _x((rows, c), torch.bfloat16, device, c + 1)
    got = ff_ops.ff_train_bwd(x, norm.gamma, lin1.weight, lin1.bias, lin2.weight, dout, rate, 7,
                              dtype=torch.bfloat16)
    xg = x.clone().requires_grad_(True)
    y = xg + ff_ops.ff_train_branch(xg, ff, torch.bfloat16, rate, 7, drop.SALT_FF)
    want = torch.autograd.grad(y, [xg, norm.gamma, lin1.weight, lin1.bias, lin2.weight, lin2.bias],
                               dout.float())
    assert got[0].dtype == torch.float32
    for i, (g, w) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g).all()), i
        assert _rel(g, w) < 2.5e-2, (i, _rel(g, w))


def _kept(seed, site, items, heads, rows, cols, device, salt, rate=0.5):
    """The plain version's mask of `site` as booleans, (items, heads, rows,
    cols) squeezed."""
    m = drop.keep_mask(seed, salt, site, items, heads, rows, cols, rate, device)
    return (m != 0).squeeze(0).squeeze(0)


@pytest.mark.parametrize("c", [32, 512])
def test_ff_train_forward_masks_match_the_plain_version(device, c):
    """B8's two masks, read off its output, equal the plain version's bit for
    bit: with W2 = 0 and b2 = 1, out - x is the output keep factor; with W1 =
    0, b1 = 1 and W2 picking hidden unit q C + j for column j, out - x is
    gelu(1) times the hidden and the output keep factors."""
    rows, m, rate, seed = 300, 4 * c, 0.5, 29
    x = _x((rows, c), torch.float32, device, 3)
    gamma, w1, b1 = (torch.ones(c, device=device), torch.zeros(m, c, device=device),
                     torch.ones(m, device=device))
    out_keep = _kept(seed, drop.SITE_FF_OUT, 1, 1, rows, c, device, drop.SALT_FF)
    hid_keep = _kept(seed, drop.SITE_FF_HIDDEN, 1, 1, rows, m, device, drop.SALT_FF)
    out = ff_ops.ff_train_fwd(x, gamma, w1, b1, torch.zeros(c, m, device=device),
                              torch.ones(c, device=device), rate, seed)
    assert torch.equal((out - x) != 0, out_keep)
    cols = torch.arange(c, device=device)
    for q in range(4):
        w2 = torch.zeros(c, m, device=device)
        w2[cols, q * c + cols] = 1.0
        out = ff_ops.ff_train_fwd(x, gamma, w1, b1, w2, torch.zeros(c, device=device), rate,
                                  seed)
        assert torch.equal((out - x) != 0, hid_keep[:, q * c:(q + 1) * c] & out_keep)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_freq_train_backward_masks_match_the_plain_version(device, dtype):
    """The four masks B7 regenerates equal the plain version's bit for bit,
    read off two weight gradients of a backward whose dout is one row r0 of
    ones. x's rows are one-hot (row r at column r % F), W_q = W_k = 0 (every
    score 0, p = 1, l = F), W_v maps the one-hot g to v_j = e_j in each head,
    W_g = 0 (gate 1/2), W1 = 0 (d_x2 = dout, pre1 = b1 = 1). Then dW_out[c]
    = f_out_attn[r0, c] go[r0] with go[r0, 32 h + j] = f_p(item, h, r0 % F,
    j) / (2 F), and dW2[c, k] = f_out_ff[r0, c] gelu(1) f_hid[r0, k]."""
    c, f, items, rate, seed = 64, 16, 2, 0.5, 31
    heads, rows, m = c // 32, items * f, 4 * c
    r = torch.arange(rows, device=device)
    x = torch.zeros(rows, c, device=device)
    x[r, r % f] = 1.0
    wqkv = torch.zeros(3 * c, c, device=device)
    for h in range(heads):
        wqkv[2 * c + 32 * h + torch.arange(f, device=device), torch.arange(f, device=device)] = (
            c**-0.5)
    params = (torch.ones(c, device=device), wqkv, torch.zeros(heads, c, device=device),
              torch.zeros(heads, device=device), _x((c, c), torch.float32, device, 1),
              torch.ones(c, device=device), torch.zeros(m, c, device=device),
              torch.ones(m, device=device), _x((c, m), torch.float32, device, 2),
              torch.zeros(c, device=device))
    cos, sin = rope_tables(f, 32, device)
    kw = dict(device=device, salt=drop.SALT_FREQ)
    attn_out = _kept(seed, drop.SITE_ATTN_OUT, 1, 1, rows, c, rate=rate, **kw)
    ff_out = _kept(seed, drop.SITE_FF_OUT, 1, 1, rows, c, rate=rate, **kw)
    ff_hid = _kept(seed, drop.SITE_FF_HIDDEN, 1, 1, rows, m, rate=rate, **kw)
    probs = _kept(seed, drop.SITE_ATTN_PROBS, items, heads, f, f, rate=rate, **kw)
    for r0 in range(rows):
        dout = torch.zeros(rows, c, dtype=dtype, device=device)
        dout[r0] = 1.0
        _, _, _, _, _, dwout, _, _, _, dw2, _ = freq_ops.freq_train_bwd(
            x.to(dtype), params, cos, sin, f, dout, rate, seed)
        rows_seen = dwout.abs().sum(1) != 0
        assert torch.equal(rows_seen, attn_out[r0])
        go = dwout[rows_seen][0].reshape(heads, 32)
        assert torch.equal(go[:, :f] != 0, probs[r0 // f, :, r0 % f])
        assert not bool(go[:, f:].any())
        assert torch.equal(dw2.abs().sum(1) != 0, ff_out[r0])
        assert torch.equal(dw2.abs().sum(0) != 0, ff_hid[r0])


def _freq_params(c, m, device, **given):
    """The ten parameters of the frequency block as freq_train_fwd takes
    them, zeros unless given: norm gains of ones, the rest by name."""
    heads = c // 32
    params = dict(ga=torch.ones(c, device=device), wqkv=torch.zeros(3 * c, c, device=device),
                  wg=torch.zeros(heads, c, device=device), gb=torch.zeros(heads, device=device),
                  wout=torch.zeros(c, c, device=device), gf=torch.ones(c, device=device),
                  w1=torch.zeros(m, c, device=device), b1=torch.zeros(m, device=device),
                  w2=torch.zeros(c, m, device=device), b2=torch.zeros(c, device=device))
    params.update(given)
    return tuple(params.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_freq_train_forward_masks_match_the_plain_version(device, dtype):
    """The four masks of B6, read off its output, equal the plain version's
    bit for bit. x's rows are one-hot (row r at column r % F), so that
    every branch value below is a multiple of 1/8 that x + branch keeps in
    bfloat16 too. Attention: W_q = W_k = 0 (every p = 1, l = F), W_g = 0 (gate 1/2), W_out
    = I and the FF off; with W_v mapping the one-hot g to v_j = e_j in each
    head, out - x at (r, 32 h + j) is nonzero iff the output mask and the
    probability mask of (item, h, r % F, j) keep it; with v = 1 everywhere,
    iff the output mask keeps (r, c) and some key of (r, head) is kept. FF
    (W_out = 0): W1 = 0, b1 = 1; with W2 = 0 and b2 = 1 out - x is the FF
    output's keep factor, with W2 picking hidden unit q C + j for column j
    it is gelu(1) times the hidden and output keep factors."""
    c, f, items, rate, seed = 64, 16, 7, 0.5, 37
    heads, rows, m = c // 32, items * f, 4 * c
    r = torch.arange(rows, device=device)
    x = torch.zeros(rows, c, device=device)
    x[r, r % f] = 1.0
    x = x.to(dtype)
    cos, sin = rope_tables(f, 32, device)
    kw = dict(device=device, salt=drop.SALT_FREQ, rate=rate)
    attn_out = _kept(seed, drop.SITE_ATTN_OUT, 1, 1, rows, c, **kw)
    ff_out = _kept(seed, drop.SITE_FF_OUT, 1, 1, rows, c, **kw)
    ff_hid = _kept(seed, drop.SITE_FF_HIDDEN, 1, 1, rows, m, **kw)
    probs = _kept(seed, drop.SITE_ATTN_PROBS, items, heads, f, f, **kw)

    def branch(**given):
        params = _freq_params(c, m, device, **given)
        out = freq_ops.freq_train_fwd(x, params, cos, sin, f, rate, seed)
        return (out.float() - x.float()) != 0

    eye, keys = torch.eye(c, device=device), torch.arange(f, device=device)
    wqkv = torch.zeros(3 * c, c, device=device)
    for h in range(heads):
        wqkv[2 * c + 32 * h + keys, keys] = c**-0.5
    got = branch(wqkv=wqkv, wout=eye).reshape(items, f, heads, 32)
    want = probs.permute(0, 2, 1, 3) & attn_out.reshape(items, f, heads, 32)[..., :f]
    assert torch.equal(got[..., :f], want)
    assert not bool(got[..., f:].any())
    wqkv = torch.zeros(3 * c, c, device=device)
    wqkv[2 * c:, :f] = c**-0.5
    some_key = probs.any(-1).permute(0, 2, 1).reshape(rows, heads, 1)
    got = branch(wqkv=wqkv, wout=eye)
    assert torch.equal(got, attn_out & some_key.expand(rows, heads, 32).reshape(rows, c))
    ones = torch.ones(m, device=device)
    assert torch.equal(branch(b1=ones, b2=torch.ones(c, device=device)), ff_out)
    cols = torch.arange(c, device=device)
    for q in range(4):
        w2 = torch.zeros(c, m, device=device)
        w2[cols, q * c + cols] = 1.0
        got = branch(b1=ones, w2=w2)
        assert torch.equal(got, ff_hid[:, q * c:(q + 1) * c] & ff_out)


@pytest.mark.parametrize("dtype,tol", TRAIN_DTYPES)
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_training_kernels_at_frontend_widths(device, dtype, tol, heads):
    """B4/B5 and B8/B9 at the frontend's widths (C 32/64/128) over enough
    rows that the weight-gradient launches derive more than 2 row-tile
    groups from the shape, dropout 0.1."""
    c, n, items = heads * 32, 600, 16
    rows = items * n
    assert -(-rows // time_ops.attn_bwd_plan(rows, c, dtype)[0]) > 2  # B5
    assert _ff_wgrad_groups(rows, c, dtype) > 2  # B9
    attn, ff = _block(c, heads, rows + c, device)
    attn.requires_grad_(True)
    ff.requires_grad_(True)
    cos, sin = rope_tables(n, 32, device)
    x = _x((items, n, c), dtype, device, c + 1)
    _compare_train(lambda t: time_ops.fused_time_attention_train(t, attn, cos, sin, heads, 0.1, 5),
                   lambda t: time_ops.fused_time_attention_train_ref(t, attn, cos, sin, heads,
                                                                     0.1, 5),
                   x, list(attn.parameters()), tol, c + 2)
    _compare_train(lambda t: ff_ops.fused_ff_train(t, ff, 0.1, 6),
                   lambda t: ff_ops.fused_ff_train_ref(t, ff, 0.1, 6),
                   x, list(ff.parameters()), tol, c + 3)


def _qkv_grads(fn, q, k, v, cot):
    """Output and dq, dk, dv of sum(fn(q, k, v) * cot)."""
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    (out.float() * cot).sum().backward()
    return [out.detach(), q.grad, k.grad, v.grad]


def _compare_qkv(kernel, plain, shape, dtype, tol, device, seed):
    q, k, v = (_x(shape, dtype, device, seed + i) for i in range(3))
    cot = _x(shape, torch.float32, device, seed + 3)
    got = _qkv_grads(kernel, q, k, v, cot)
    want = _qkv_grads(plain, q, k, v, cot)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == torch.Size(shape), name
        assert bool(torch.isfinite(g.float()).all()), name
        if shape[1] == 1 and name in ("dq", "dk"):
            # one key: the softmax is constant and dq = dk = 0; each side gives the
            # rounding of dp - delta, two numbers of the size of dout * v
            assert max(float(g.float().abs().max()), float(w.float().abs().max())) < 10 * tol
        else:
            assert _rel(g, w) < tol, (name, _rel(g, w))
    return got


@pytest.mark.parametrize("dtype,tol", TRAIN_DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("n,d,bh,heads,rope", [(1, 16, 3, 1, True), (31, 32, 4, 2, True),
                                               (200, 16, 6, 3, True), (200, 32, 2, 1, False),
                                               (1500, 16, 2, 2, True)])
def test_flash_attention(device, dtype, tol, rate, n, d, bh, heads, rope):
    """B10 (with lse) and B11 against flash_attention_ref: output and dq, dk,
    dv at ragged lengths, with the same Philox mask on both sides."""
    cos, sin = rope_tables(n, d, device) if rope else (None, None)
    before = (flash_ops.flash_fwd.launches, flash_ops.flash_fwd_lse.launches,
              flash_ops.flash_bwd.launches)
    got = _compare_qkv(
        lambda q, k, v: flash_ops.flash_attention(q, k, v, cos, sin, rate, 31, heads),
        lambda q, k, v: flash_ops.flash_attention_ref(q, k, v, cos, sin, rate, 31, heads),
        (bh, n, d), dtype, tol, device, n + d)
    assert (flash_ops.flash_fwd.launches, flash_ops.flash_fwd_lse.launches,
            flash_ops.flash_bwd.launches) == (before[0], before[1] + 1, before[2] + 1)
    # without a gradient to compute, the forward that writes no lse: the same output
    q, k, v = (_x((bh, n, d), dtype, device, n + d + i) for i in range(3))
    with torch.no_grad():
        out = flash_ops.flash_attention(q, k, v, cos, sin, rate, 31, heads)
    assert flash_ops.flash_fwd.launches == before[0] + 1
    assert torch.equal(out, got[0])


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("heads,rope", [(1, True), (1, False), (2, True), (2, False)])
@pytest.mark.parametrize("n", [1, 17, 63, 64, 65, 1500])
@pytest.mark.parametrize("d,dtype,tol", [
    pytest.param(16, torch.bfloat16, 2.5e-2, id="16"),
    pytest.param(32, torch.bfloat16, 2.5e-2, id="32"),
    pytest.param(16, torch.float32, 1e-4, id="16-float32"),
    pytest.param(32, torch.float32, 1e-4, id="32-float32"),
])
def test_flash_attention_bf16_tensor_cores(device, d, dtype, tol, n, heads, rope, rate):
    """The tensor-core kernels in both dtypes (float32 as split bf16
    products): B10 with lse and B11 (output, dq, dk, dv), then B10 without
    lse (the same output bits), against flash_attention_ref within the
    training limits (2.5e-2 bfloat16, 1e-4 float32), at lengths around the
    64-row tiles and the model's 1500."""
    cos, sin = rope_tables(n, d, device) if rope else (None, None)
    shape = (2 * heads, n, d)
    got = _compare_qkv(
        lambda q, k, v: flash_ops.flash_attention(q, k, v, cos, sin, rate, 5, heads),
        lambda q, k, v: flash_ops.flash_attention_ref(q, k, v, cos, sin, rate, 5, heads),
        shape, dtype, tol, device, 7 * n + d)
    q, k, v = (_x(shape, dtype, device, 7 * n + d + i) for i in range(3))
    with torch.no_grad():
        assert torch.equal(flash_ops.flash_attention(q, k, v, cos, sin, rate, 5, heads), got[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_masks_match_the_plain_version(device, dtype):
    """B10's probability mask, read off its output, equals the plain
    version's bit for bit. q = k = 0, so every p = 1 and l = n; v is one-hot
    on a window of D keys (key w D + j at channel j, zero elsewhere), so
    o at (entry, query, j) is nonzero iff the mask keeps key w D + j. The
    windows cover every key of a length that spans ragged 64-key tiles."""
    bh, n, d, heads, rate, seed = 6, 200, 16, 3, 0.2, 23
    cos, sin = rope_tables(n, d, device)
    zeros = torch.zeros((bh, n, d), dtype=dtype, device=device)
    want = flash_ops.probs_keep(seed, 0, bh, heads, n, n, rate, device) != 0
    before = flash_ops.flash_fwd.launches
    for w in range(-(-n // d)):
        keys = torch.arange(w * d, min((w + 1) * d, n), device=device)
        v = zeros.clone()
        v[:, keys, keys - w * d] = 1.0
        with torch.no_grad():
            out = flash_ops.flash_attention(zeros, zeros, v, cos, sin, rate, seed, heads)
        assert torch.equal(out[..., : len(keys)] != 0, want[..., keys])
        assert not bool(out[..., len(keys):].any())
    assert flash_ops.flash_fwd.launches == before + -(-n // d)


@pytest.mark.parametrize("f", [32, 8, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_forward_masks_match_the_plain_version(device, dtype, f):
    """B12's probability mask, read off its output, equals the plain
    version's bit for bit. q = k = 0, so every p = 1 and l = F; v is one-hot
    on a window of D keys (key w D + j at channel j, zero elsewhere), so o at
    (item, query, j) is nonzero iff the mask keeps key w D + j. Ragged
    64-row blocks; 16 / F items a 16-key tile at F 8 and 1, one item a 32-key
    tile at F 32."""
    items, d, heads, rate, seed = 45, 16, 3, 0.2, 29
    cos, sin = rope_tables(f, d, device)
    zeros = torch.zeros((items, f, d), dtype=dtype, device=device)
    want = flash_ops.probs_keep(seed, 0, items, heads, f, f, rate, device) != 0
    before = small_ops.small_fwd.launches
    for w in range(-(-f // d)):
        keys = torch.arange(w * d, min((w + 1) * d, f), device=device)
        v = zeros.clone()
        v[:, keys, keys - w * d] = 1.0
        with torch.no_grad():
            out = small_ops.small_attention(zeros, zeros, v, cos, sin, rate, seed, heads)
        assert torch.equal(out[..., : len(keys)] != 0, want[..., keys])
        assert not bool(out[..., len(keys):].any())
    assert small_ops.small_fwd.launches == before + -(-f // d)


@pytest.mark.parametrize("dtype,tol", TRAIN_DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("f,d,items,heads", [(32, 16, 5, 1), (16, 16, 37, 2), (8, 16, 301, 4),
                                             (8, 32, 45, 3), (32, 32, 9, 2), (4, 16, 50, 1),
                                             (2, 32, 21, 2), (1, 16, 130, 1)])
def test_small_attention(device, dtype, tol, rate, f, d, items, heads):
    """B12 forward and backward against small_attention_ref: every F
    dividing 32, item counts that do not fill the last block."""
    cos, sin = rope_tables(f, d, device)
    before = (small_ops.small_fwd.launches, small_ops.small_bwd.launches)
    _compare_qkv(
        lambda q, k, v: small_ops.small_attention(q, k, v, cos, sin, rate, 37, heads),
        lambda q, k, v: small_ops.small_attention_ref(q, k, v, cos, sin, rate, 37, heads),
        (items, f, d), dtype, tol, device, f + d + items)
    assert (small_ops.small_fwd.launches, small_ops.small_bwd.launches) == (
        before[0] + 1, before[1] + 1)



# a shard's first item in the global batch (ops/dropout.py: item0, and row0 =
# item0 times the rows per item)
BASE_ITEM0 = 3


def _train_case(name, device, b=BASE_ITEM0):
    """(kernel, plain, inputs, parameters) of the training op that launches
    kernel `name`, both sides drawing their masks at item `b` of the global
    batch, rate 0.5, float32: B4 / B5 the time-axis branch, B6 / B7 the
    frequency block, B8 / B9 the feed-forward residual, B10 / B11 flash
    attention, B12 small attention."""
    rate, seed, dtype = 0.5, 41, torch.float32
    if name in ("B4", "B5"):
        heads, n, c = 2, 130, 64
        attn, _ = _block(c, heads, 71, device)
        cos, sin = rope_tables(n, 32, device)
        return (lambda t: time_ops.fused_time_attention_train(t, attn, cos, sin, heads, rate,
                                                               seed, b),
                lambda t: time_ops.fused_time_attention_train_ref(t, attn, cos, sin, heads, rate,
                                                                   seed, b),
                (_x((3, n, c), dtype, device, 72),), list(attn.parameters()))
    if name in ("B6", "B7"):
        f, c = 16, 64
        attn, ff = _block(c, c // 32, 73, device)
        cos, sin = rope_tables(f, 32, device)
        return (lambda t: freq_ops.fused_freq_roformer_train(t, attn, ff, cos, sin, rate, seed, b),
                lambda t: freq_ops.fused_freq_roformer_train_ref(t, attn, ff, cos, sin, rate,
                                                                 seed, b),
                (_x((150, f, c), dtype, device, 74),),
                list(attn.parameters()) + list(ff.parameters()))
    if name in ("B8", "B9"):
        _, ff = _block(64, 2, 75, device)
        return (lambda t: ff_ops.fused_ff_train(t, ff, rate, seed, b),
                lambda t: ff_ops.fused_ff_train_ref(t, ff, rate, seed, b),
                (_x((5, 21, 64), dtype, device, 76),), list(ff.parameters()))
    n, d, heads, ops = (200, 16, 3, flash_ops) if name in ("B10", "B11") else (8, 16, 4, small_ops)
    cos, sin = rope_tables(n, d, device)
    kernel = flash_ops.flash_attention if ops is flash_ops else small_ops.small_attention
    plain = flash_ops.flash_attention_ref if ops is flash_ops else small_ops.small_attention_ref
    return (lambda q, k, v: kernel(q, k, v, cos, sin, rate, seed, heads, b),
            lambda q, k, v: plain(q, k, v, cos, sin, rate, seed, heads, b),
            tuple(_x((2 * heads, n, d), dtype, device, 77 + i) for i in range(3)), [])


@pytest.mark.parametrize("name", ["B4", "B5", "B6", "B7", "B8", "B9", "B10", "B11", "B12"])
def test_training_kernels_draw_at_a_global_batch_base(device, name):
    """Each training kernel at a batch base (a data-parallel shard's first
    item) equals its plain version at that base: the forward kernels'
    outputs, the backward kernels' gradients of the inputs and parameters,
    float32 (1e-4, as `_compare_train`). Rate 0.5, so a mask drawn at the
    wrong base puts about half the elements off. And the base moves the
    masks: the kernel's result at base 0 is far from it."""
    kernel, plain, inputs, params = _train_case(name, device)
    forward = name in ("B4", "B6", "B8", "B10")
    for p in params:
        p.requires_grad_(not forward)
    inputs = [t.clone().requires_grad_(not forward) for t in inputs]
    if forward:
        with torch.no_grad():
            got, want = [kernel(*inputs)], [plain(*inputs)]
    else:
        cot = _x(inputs[0].shape, torch.float32, device, 99)
        leaves = inputs + params

        def grads(fn):
            out = fn(*inputs)
            return [out.detach(), *torch.autograd.grad((out.float() * cot).sum(), leaves)]

        got, want = grads(kernel), grads(plain)
    for i, (g, w) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g.float()).all()), i
        assert _rel(g, w) < 1e-4, (name, i, _rel(g, w))
    with torch.no_grad():
        assert _rel(_train_case(name, device, 0)[0](*inputs), got[0]) > 0.1, name


def test_small_attention_without_tables(device):
    _compare_qkv(lambda q, k, v: small_ops.small_attention(q, k, v),
                 lambda q, k, v: small_ops.small_attention_ref(q, k, v),
                 (40, 16, 16), torch.float32, 1e-4, device, 3)


@pytest.mark.parametrize("name", ["flash", "small", "flash32"])
def test_attention_backward_is_deterministic(device, name):
    """Two backward runs give the same bits (dk and dv by a key-major pass,
    no float atomics)."""
    if name.startswith("flash"):
        d = 32 if name == "flash32" else 16
        shape, (cos, sin) = (4, 700, d), rope_tables(700, d, device)
        fn = lambda q, k, v: flash_ops.flash_attention(q, k, v, cos, sin, 0.2, 3, 2)  # noqa: E731
    else:
        shape, (cos, sin) = (500, 16, 16), rope_tables(16, 16, device)
        fn = lambda q, k, v: small_ops.small_attention(q, k, v, cos, sin, 0.2, 3, 2)  # noqa: E731
    q, k, v = (_x(shape, torch.bfloat16, device, i) for i in range(3))
    cot = _x(shape, torch.float32, device, 4)
    for a, b in zip(_qkv_grads(fn, q, k, v, cot), _qkv_grads(fn, q, k, v, cot)):
        assert torch.equal(a, b)


def test_attention_kernels_take_views_and_refuse_other_shapes(device):
    """Strided views, and a contiguous view that starts 4 bytes into its
    buffer (the kernels load rows 16 bytes at a time), give the plain
    version's result; an unsupported head width or sequence length raises
    and names the supported ones."""
    qkv = _x((3, 4, 33, 16), torch.float32, device, 1)
    q, k = qkv[0, :, 1:], qkv[1, :, 1:]
    v = _x((4 * 32 * 16 + 1,), torch.float32, device, 2)[1:].view(4, 32, 16)
    assert v.is_contiguous() and v.data_ptr() % 16 != 0
    cos, sin = rope_tables(32, 16, device)
    assert _rel(flash_ops.flash_attention(q, k, v, cos, sin),
                flash_ops.flash_attention_ref(q, k, v, cos, sin)) < 1e-5
    assert _rel(small_ops.small_attention(q, k, v, cos, sin),
                small_ops.small_attention_ref(q, k, v, cos, sin)) < 1e-5
    bad = torch.zeros((2, 8, 24), device=device)
    with pytest.raises(ValueError, match=r"head_dim in \(16, 32\)"):
        flash_ops.flash_attention(bad, bad, bad)
    bad = torch.zeros((2, 24, 16), device=device)
    with pytest.raises(ValueError, match="sequence lengths"):
        small_ops.small_attention(bad, bad, bad)


# -- the ablation kernels of beat_this_tpu_torch/bench/ ----------------------------


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("stage", ["copy", "rms", "qkv", "ff", "attn", "full"])
@pytest.mark.parametrize("c,f,items", [(32, 32, 5), (64, 16, 7), (128, 8, 37)])
def test_freq_ablate_stage(device, dtype, tol, stage, c, f, items):
    from beat_this_tpu_torch.bench import fused_freq_ablate as fa

    x, params, (cos, sin) = fa.make_case(np.random.RandomState(c + f), c, f, items, device, dtype)
    before = fa.ablate_stage.launches
    got = fa.ablate_stage(x, params, stage, cos, sin)
    assert fa.ablate_stage.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, fa.ablate_stage_ref(x, params, stage, cos, sin)) < tol
    if stage == "full":  # the block's own launch, bit for bit
        assert torch.equal(got, fused_freq_roformer(x, *params, cos, sin))
    if stage == "copy":
        assert torch.equal(got, x)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("c,f,items", [(32, 32, 5), (64, 16, 7), (128, 8, 37)])
def test_freq_ablate_stages_add_up(device, dtype, tol, c, f, items):
    """The cuts are the block's own kernel cut: ff over attn's output is
    `full` (in bfloat16 up to the rounding of y1 to the dtype)."""
    from beat_this_tpu_torch.bench import fused_freq_ablate as fa

    x, params, (cos, sin) = fa.make_case(np.random.RandomState(c), c, f, items, device, dtype)
    y1 = fa.ablate_stage(x, params, "attn", cos, sin)
    got = fa.ablate_stage(y1, params, "ff", cos, sin)
    assert _rel(got, fa.ablate_stage(x, params, "full", cos, sin)) < tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("mode", ["full", "norope", "noexp", "mxu_only"])
@pytest.mark.parametrize("bh,n,d,block_k,rope", [(3, 200, 32, 64, True), (2, 256, 32, 128, False),
                                                 (4, 77, 16, 32, True)])
def test_flash_variant(device, dtype, tol, mode, bh, n, d, block_k, rope):
    from beat_this_tpu_torch.bench import flash_ablate as fl

    q, k, v = (_x((bh, n, d), dtype, device, 10 * i + n) for i in range(3))
    cos, sin = rope_tables(n, d, device) if rope else (None, None)
    before = fl.flash_variant.launches
    got = fl.flash_variant(q, k, v, cos, sin, mode, block_k)
    assert fl.flash_variant.launches == before + 1
    want, den = fl.flash_variant_ref(q, k, v, cos, sin, mode, block_k, with_denominator=True)
    assert got.dtype == dtype and got.shape == q.shape
    if mode == "noexp":  # divides by a sum of scores that crosses zero: hold the rows away from it
        got, got_den = fl.flash_variant(q, k, v, cos, sin, mode, block_k, with_denominator=True)
        assert float((got_den - den).abs().max()) < 1e-3 * float(den.abs().max())
        # the numerator o * l on every row, each side with its own l
        assert _rel(got.float() * got_den[..., None], want.float() * den[..., None]) < tol
        keep = den.abs() >= 0.25 * den.abs().max()
        got, want = got[keep], want[keep]
    assert _rel(got, want) < tol
    if mode == "full":  # the model's own forward
        assert torch.equal(got, flash_ops.flash_attention(q, k, v, cos, sin))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("variant", ["nosmax", "nomax", "noexp", "b16exp", "full", "kfold", "b16s",
                                     "b16sfold", "tfull", "tmxusum", "tb16sum"])
@pytest.mark.parametrize("items,n,valid,heads", [(3, 200, 170, 2), (2, 128, 128, 1),
                                                 (1, 200, 150, 4), (2, 77, 70, 1)])
def test_attention_variant(device, dtype, tol, variant, items, n, valid, heads):
    from beat_this_tpu_torch.bench import softmax_variants as sv

    q, k, v = sv.make_qkv(np.random.RandomState(n + heads), items, n, heads, device, dtype)
    mask, mask_col = sv.make_masks(n, valid, device)
    before = sv.attention_variant.launches
    got = sv.attention_variant(q, k, v, mask, variant, heads, mask_col)
    assert sv.attention_variant.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = sv.attention_variant_ref(q, k, v, mask, variant, heads, mask_col)
    assert bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32 and variant == "nosmax" and valid == n:
        # o = sum(s v) / sum(s) with row sums of scores that cross zero: the
        # float32 plain version is itself over 1e-5 from the exact answer
        # there (tests/test_torch_softmax_variants_design.py), so this case
        # is held to float64, within twice the plain version's own distance
        exact = sv.attention_variant_ref(q.double(), k.double(), v.double(), mask, variant,
                                         heads, mask_col)
        assert _rel64(got, exact) < 2 * _rel64(want, exact)
    else:
        assert _rel(got, want) < tol


def test_attention_variants_are_pairwise_distinguishable(device):
    """As tests/test_torch_bench_ablate.py holds the plain versions: bfloat16,
    half of the keys under a mask of -1.01, so that the mask add, the
    rounded mask column, the rounded scores, each pass and the denominators
    all show in the kernels' outputs."""
    import itertools

    from beat_this_tpu_torch.bench import softmax_variants as sv

    items, n, gh = 2, 128, 2
    q, k, v = sv.make_qkv(np.random.RandomState(11), items, n, gh, device, torch.bfloat16)
    mask = torch.zeros(n, device=device)
    mask[n // 2:] = -1.01
    outs = {var: sv.attention_variant(q * 4, k * 4, v, mask, var, gh) for var in sv.VARIANTS}
    same = [{"b16s", "b16sfold"}, {"full", "tmxusum", "tb16sum"}]
    for a, b in itertools.combinations(sv.VARIANTS, 2):
        if any({a, b} <= group for group in same):
            assert _rel(outs[a], outs[b]) < 1e-2, (a, b)
        else:
            assert not torch.equal(outs[a], outs[b]), (a, b)
    for a, b in (("tfull", "tb16sum"), ("full", "kfold")):
        assert not torch.equal(outs[a], outs[b])


@pytest.mark.parametrize("op", ["exp2", "rowmax", "rowsum"])
@pytest.mark.parametrize("rows,cols,out_cols", [(37, 1536, 128), (8, 100, 100), (3, 33, 1),
                                                (1, 1536, 1536), (8451, 1536, 128)])
def test_softmax_pass(device, op, rows, cols, out_cols):
    from beat_this_tpu_torch.bench import softmax_variants as sv

    x = _x((rows, cols), torch.float32, device, rows) * 2
    before = sv.softmax_pass.launches
    got = sv.softmax_pass(x, op, out_cols)
    assert sv.softmax_pass.launches == before + 1
    assert got.shape == (rows, out_cols)
    assert _rel(got, sv.softmax_pass_ref(x, op, out_cols)) < 1e-5


# -- the DBN decoder on the card against the CPU -------------------------------------


def _dbn_tracks():
    """[beat-only, downbeat] activations: 4/4 and 3/4 clicks plus noise, an
    all-below-threshold track, a one-frame track and a flat one (ties)."""
    rng = np.random.default_rng(0)
    tracks = []
    for frames, bpb, period in ((700, 4, 25), (450, 3, 30), (1000, 4, 33)):
        act = 1e-3 + 0.05 * rng.random((frames, 2))
        for i, t in enumerate(range(period // 2, frames, period)):
            act[t] = (0.02, 0.9) if i % bpb == 0 else (0.85, 0.02)
        tracks.append(act)
    return tracks + [np.full((120, 2), 0.01), np.array([[0.6, 0.1]]), np.full((90, 2), 0.25)]


@pytest.mark.parametrize("batched", [False, True])
def test_dbn_decoder_on_the_card_equals_cpu(device, batched):
    from beat_this_tpu_torch.postprocessing.dbn import DbnDecoder

    card, cpu = DbnDecoder(device=device), DbnDecoder()
    tracks = _dbn_tracks()
    got = card.decode_many(tracks) if batched else [card(t) for t in tracks]
    want = cpu.decode_many(tracks)
    assert sum(len(w) > 0 for w in want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


def test_dbn_forward_on_the_card_equals_cpu(device):
    """Scores at 1e-4 relative (float32 adds in the same order; exp and log
    are not involved), choices exactly, also where candidates tie."""
    from beat_this_tpu_torch.postprocessing import dbn

    decoder = dbn.DbnDecoder()
    dens = np.stack([decoder._log_densities(t) for t in (_dbn_tracks()[1], np.full((450, 2), 0.25))])
    dens = torch.from_numpy(dens.astype(np.float32))
    lengths = torch.tensor([450, 300])
    for tensors in decoder._tensors:
        final, choices = dbn.viterbi_forward(*tensors, dens, lengths)
        on_card = [t.to(device) for t in tensors]
        got_final, got_choices = dbn.viterbi_forward(*on_card, dens.to(device), lengths.to(device))
        assert torch.equal(got_choices.cpu(), choices)
        assert _rel(got_final.cpu(), final) < 1e-4
        starts = final.argmax(1)
        path = dbn.viterbi_backtrack(tensors[0], choices, starts)
        got_path = dbn.viterbi_backtrack(on_card[0], got_choices, starts.to(device))
        assert torch.equal(got_path.cpu(), path)

