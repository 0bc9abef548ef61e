"""The three CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes the main path does not reach: row counts that
are not a multiple of the 32-row tile, sequence lengths that are not a
multiple of the attention tiles, every supported width. Needs a CUDA device
and nvcc; skips without one. Run on the GPU machine with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

(the repository's conftest.py imports JAX, which that machine lacks).
Tolerances: float32 relative max deviation 1e-5 (TF32 off; only the order
of float32 sums differs), bfloat16 < 2.5e-2 (the two sides round
intermediates to bfloat16 at different places)."""

import numpy as np
import pytest
import torch

from beat_this_tpu_torch.model.layers import Attention, FeedForward
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


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("c", [32, 64, 128, 512])
def test_fused_ff(device, dtype, tol, c):
    _, ff = _block(c, c // 32, c, device)
    x = _x((2, 45, c), dtype, device, c)
    before = fused_ff.launches
    got = fused_ff(x, ff)
    assert fused_ff.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, fused_ff_ref(x, ff)) < tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("heads,n,items", [(1, 77, 3), (2, 130, 2), (4, 64, 1), (16, 200, 1)])
def test_fused_time(device, dtype, tol, heads, n, items):
    c = heads * 32
    attn, ff = _block(c, heads, n, device)
    cos, sin = rope_tables(n, 32, device)
    x = _x((items, n, c), dtype, device, n)
    got = fused_time_roformer(x, attn, ff, cos, sin, heads)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, fused_time_roformer_ref(x, attn, ff, cos, sin, heads)) < tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("f,c,items", [(32, 32, 5), (16, 64, 7), (8, 128, 37), (4, 64, 9)])
def test_fused_freq(device, dtype, tol, f, c, items):
    attn, ff = _block(c, c // 32, f * c, device)
    cos, sin = rope_tables(f, 32, device)
    x = _x((items, f, c), dtype, device, f)
    got = fused_freq_roformer(x, attn, ff, cos, sin)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, fused_freq_roformer_ref(x, attn, ff, cos, sin)) < tol


def test_unsupported_width_raises(device):
    _, ff = _block(96, 3, 0, device)
    with pytest.raises(ValueError, match="supports C"):
        fused_ff(torch.zeros((4, 96), device=device), ff)
