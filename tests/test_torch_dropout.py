"""The port's counter-based dropout (`ops/dropout.py`): the Philox4x32-10
known-answer vectors of Random123, the keep fraction, independence across
sites, seeds and coordinates, and float64 gradchecks of the training plain
versions at rate 0.2 with a fixed seed (the forward and backward use the
same mask), the role of tools/check_all_tpu.py:332-390 for the TPU kernels.
"""

import numpy as np
import pytest
import torch
from torch import nn
from torch.func import functional_call

from beat_this_tpu_torch.model.layers import Attention, FeedForward
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops.fused_ff import fused_ff_train_ref
from beat_this_tpu_torch.ops.fused_time import fused_time_attention_train_ref
from beat_this_tpu_torch.ops.rotary import rope_tables

M = 0xFFFFFFFF


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M, M, M, M), (M, M), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    got = tuple(int(w) for w in drop.philox4x32([torch.tensor(c) for c in ctr], key))
    assert got == want


def _mask(seed=1, salt=drop.SALT_ATTN, site=drop.SITE_ATTN_PROBS, rate=0.2, shape=(2, 4, 128, 130)):
    return drop.keep_mask(seed, salt, site, *shape, rate)


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_keep_fraction_and_scale(rate):
    m = _mask(rate=rate)
    n = m.numel()
    keep = 1.0 - rate
    frac = float((m > 0).float().mean())
    assert abs(frac - keep) < 4 * np.sqrt(keep * rate / n)
    kept = m[m > 0]
    assert torch.all(kept == torch.tensor(1.0 / keep, dtype=torch.float32))


@pytest.mark.parametrize("other", [
    dict(seed=2), dict(site=drop.SITE_ATTN_OUT), dict(salt=drop.SALT_FF),
])
def test_masks_of_other_sites_and_seeds_are_independent(other):
    """Joint keep frequency of two masks within 4 sigma of keep^2."""
    a, b = _mask() > 0, _mask(**other) > 0
    n, p = a.numel(), 0.8 * 0.8
    assert not torch.equal(a, b)
    assert abs(float((a & b).float().mean()) - p) < 4 * np.sqrt(p * (1 - p) / n)


def test_masks_of_other_coordinates_are_independent():
    """Neighbouring items, heads, rows and column groups do not repeat."""
    m = _mask() > 0
    for x, y in ((m[0], m[1]), (m[:, 0], m[:, 1]), (m[..., 0, :], m[..., 1, :]),
                 (m[..., :4], m[..., 4:8])):
        p = 0.64
        assert abs(float((x & y).float().mean()) - p) < 4 * np.sqrt(p * (1 - p) / x.numel())


def test_mask_is_a_pure_function_of_coordinates():
    """A sub-grid equals the corresponding slice of a larger grid."""
    big = _mask(shape=(3, 2, 40, 70))
    small = _mask(shape=(2, 1, 25, 33))
    assert torch.equal(big[:2, :1, :25, :33], small)


def test_kernel_args():
    assert drop.kernel_args(0.0, 5, 7) == (0, 7, 0, 1.0, 0)
    assert drop.kernel_args(0.2, None, 7)[-1] == 0
    seed, salt, thr, scale, on = drop.kernel_args(0.2, 5, 7)
    assert (seed, salt, on) == (5, 7, 1)
    assert thr == 3435973837  # ceil(0.8 * 2**32)
    assert scale == float(np.float32(1.25))


class _Wrap(nn.Module):
    def __init__(self, fn, mod):
        super().__init__()
        self.mod, self.fn = mod, fn

    def forward(self, x):
        return self.fn(x, self.mod)


def _gradcheck(fn, mod, x):
    """Float64 gradcheck of fn(x, mod) w.r.t. x and every parameter."""
    mod = mod.double()
    wrap = _Wrap(fn, mod)
    names = [n for n, _ in wrap.named_parameters()]
    params = [p.detach().clone().requires_grad_(True) for _, p in wrap.named_parameters()]

    def call(x, *ps):
        return functional_call(wrap, dict(zip(names, ps)), (x,))

    assert torch.autograd.gradcheck(call, (x, *params), fast_mode=True)


def _init(mod, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(0.5 * rng.standard_normal(p.shape)) + (p.ndim == 1))
    return mod


def test_ff_train_ref_gradcheck_with_dropout():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 5, 32))).requires_grad_(True)
    _gradcheck(lambda x, ff: fused_ff_train_ref(x, ff, 0.2, 1234), _init(FeedForward(32), 1), x)


def test_attention_train_ref_gradcheck_with_dropout():
    n, heads = 12, 2
    cos, sin = rope_tables(n, 32)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, n, 64))).requires_grad_(True)
    _gradcheck(lambda x, a: fused_time_attention_train_ref(x, a, cos, sin, heads, 0.2, 99),
               _init(Attention(64, heads), 3), x)
