"""The design of the feed-forward training backward (B9,
`beat_this_tpu_torch/csrc/fused_ff_train.cu`), checked on the CPU before the
card: the float32 split products (each operand as two bf16 parts, three
bf16 products summed in float32) against float64, and the wrapper's choice
of row groups for the weight-gradient products. The plain version is held
to the Pallas backward in tests/test_torch_train_kernels_ref.py, the kernel
to the plain version in tests/test_torch_cuda_kernels.py.

Tolerance: a split product within 1e-4 of float64 relative to its largest
entry (about 16 significant bits per operand), while one bf16 product
misses 1e-3.
"""

import numpy as np
import pytest
import torch

from beat_this_tpu_torch.ops import fused_ff as ff_ops


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _split(t: torch.Tensor, parts: int):
    """hi and lo bf16 parts of float32 `t` (lo zero with one part)."""
    hi = _bf16(t)
    return hi, (_bf16(t - hi) if parts == 2 else torch.zeros_like(t))


def _split_mm(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a @ b as the kernel's products take it: a_hi b_hi + a_hi b_lo + a_lo
    b_hi in float32 (two parts, float32), or a_hi b_hi (one part, bf16)."""
    ah, al = _split(a, parts)
    bh, bl = _split(b, parts)
    return al @ bh + ah @ bl + ah @ bh


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("m,k,n,positive_b", [
    (96, 512, 256, False),    # pre1 = g W1^T and d_h1 = d_y W2 at C 512
    (96, 2048, 128, False),   # d_g = d_pre1 W1 at C 512 (M 2048)
    (64, 2400, 128, False),   # dW1 over one row group at C 512 (12000 rows / 5)
    (64, 2400, 128, True),    # dW2: h1d = gelu(.) f is mostly positive
    (32, 12000, 32, False),   # a whole 12000-row sum in one group
])
def test_split_product_meets_float32_limit(m, k, n, positive_b):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    if positive_b:
        b = np.abs(b)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = _split_mm(torch.from_numpy(a), torch.from_numpy(b), 2).numpy()
    assert _rel(got, want) < 1e-4
    one_pass = _split_mm(torch.from_numpy(a), torch.from_numpy(b), 1).numpy()
    assert _rel(one_pass, want) > 1e-3  # why float32 needs the split


ROWS = [1, 31, 32, 33, 127, 128, 129, 1000, 1537, 9600, 12000, 96000, 192000, 384000]


# the output tiles of one weight-gradient product at C 32, 64, 128, 256, 384
# and 512 (csrc/fused_ff_train.cu: bt_ff_wgrad_tiles)
@pytest.mark.parametrize("tiles", [1, 2, 4, 16, 36, 64])
def test_wgrad_split_fills_the_card(tiles):
    target = -(-2 * ff_ops.CARD_SMS // tiles)
    for rows in ROWS:
        per = ff_ops.ff_wgrad_split(rows, tiles)
        groups = -(-rows // per)
        # the kernel's group z takes rows [z per, min((z + 1) per, rows)):
        # every group holds at least one row and at least the fewest rows a
        # group takes, unless it is the only or the last one
        assert per >= ff_ops.FF_MIN_GROUP_ROWS and (groups - 1) * per < rows, (rows, per)
        # about two blocks per SM and never more, unless the rows run out first
        assert groups <= target
        if rows >= 2 * ff_ops.CARD_SMS * ff_ops.FF_MIN_GROUP_ROWS:
            assert tiles * groups >= 1.5 * ff_ops.CARD_SMS


def test_wgrad_split_at_the_main_shapes():
    def groups(rows, tiles):
        return -(-rows // ff_ops.ff_wgrad_split(rows, tiles))

    # C 512 main layer (8 x 1500 rows): 64 output tiles x 5 groups of 2400 rows
    assert ff_ops.ff_wgrad_split(12000, 64) == 2400
    # the frontend's time blocks, C 32 / 64 / 128: 1 / 2 / 4 tiles per group
    assert [groups(r, t) for r, t in ((384000, 1), (192000, 2), (96000, 4))] == [264, 132, 66]
    # the GPU test at the frontend's widths takes more than two groups
    assert all(groups(9600, t) > 2 for t in (1, 2, 4))
    # the split-group GPU cases at C 512
    assert groups(1000, 64) == 4 and groups(1537, 64) == 5
