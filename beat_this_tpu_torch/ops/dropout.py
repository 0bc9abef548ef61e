"""Counter-based dropout masks shared by the CUDA training kernels and their
plain PyTorch versions.

The TPU kernels draw their masks from `pltpu.prng_*`, salted by grid block
(beat_this_tpu/ops/fused_freq.py:_dropmask), which has no CUDA counterpart.
The port uses Philox4x32-10 (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC 2011) keyed by (seed, salt) with the counter
(col // 4, row, item, site << 16 | head): one call gives the bits of four
neighbouring columns. An element is kept iff its 32 bits, read as the
uniform u = bits / 2**32, satisfy u < 1 - rate, and a kept element is
scaled by 1 / (1 - rate). The mask depends only on an element's
coordinates, so a forward and a backward kernel regenerate the same mask
whatever their tiling, and the plain version below computes the same bits
(uint32 arithmetic in int64 tensors) as `csrc/philox.cuh`: with the same
seed, kernel and plain version drop the same elements.

Sites: the attention probabilities (coordinates item, head, query row, key
column), the attention output and the two feed-forward sites (coordinates
row of the flattened (rows, C) activations, column). The fused
frequency-axis block draws all four under SALT_FREQ; the time-axis
attention branch and the feed-forward residual under SALT_ATTN and SALT_FF.

Every call's items and rows are batch-major, and a call counts them from
its own first. A shard of a data-parallel batch passes its first item
`item0` (its first global batch row times the items per batch row) and its
first row `row0` (item0 times the rows per item): a probability site adds
item0 to its item, a row site row0 to its row, so the shard draws the bits
of its elements in the mask of the whole batch. At 0 nothing changes.
"""

from __future__ import annotations

import math

import torch

SITE_ATTN_PROBS, SITE_ATTN_OUT, SITE_FF_HIDDEN, SITE_FF_OUT = 0, 1, 2, 3
# the key's second word: one salt per fused operation (SALT_FREQ: the whole
# frequency-axis block, all four of its sites)
SALT_ATTN, SALT_FF, SALT_FREQ = 0x7A77, 0x0FF0, 0xF4E9
# elements per chunk of `keep_mask_entries`: bounds its int64 temporaries
# (~10 live tensors of this many elements, 1.3 GB) while a chunk is still
# large enough to fill a GPU (seven (1500, 1500) entries)
MASK_CHUNK = 1 << 24

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of m * c for a uint32 constant m and uint32
    values c held in int64, with no intermediate above 2**49."""
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    lo = (((b & 0xFFFF) << 16) + a) & _MASK32
    hi = (b + (a >> 16)) >> 16
    return hi, lo


def philox4x32(ctr, key: tuple[int, int]) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 of the counter words `ctr` (four broadcastable int64
    tensors of uint32 values) under `key` (two uint32 ints); returns the
    four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """The integer t with bits < t  <=>  bits / 2**32 < 1 - rate."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must lie in (0, 1), got {rate}")
    return min(math.ceil((1.0 - rate) * 2**32), _MASK32)


def keep_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to float32, as the kernels multiply by it."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def keep_mask_entries(seed: int, salt: int, site: int, items: torch.Tensor,
                      heads: torch.Tensor, rows: int, cols: int, rate: float,
                      row0: int = 0) -> torch.Tensor:
    """(len(items), rows, cols) float32 mask: 0 where dropped, 1 / (1 - rate)
    where kept, for the elements (items[e], heads[e], row0 + row, col) of
    `site`; `items` and `heads` are int64 tensors of one length on the mask's
    device. Entries are drawn in chunks of at most MASK_CHUNK elements (at
    least one entry per chunk); the bits depend only on the coordinates,
    not on the chunking."""
    thr, scale = keep_threshold(rate), keep_scale(rate)
    device = items.device
    groups = -(-cols // 4)
    c0 = torch.arange(groups, device=device, dtype=torch.int64)
    c1 = (torch.arange(rows, device=device, dtype=torch.int64)[:, None] + row0) & _MASK32
    c2 = items[:, None, None]
    c3 = ((site << 16) | heads)[:, None, None]
    out = torch.empty((len(items), rows, cols), dtype=torch.float32, device=device)
    step = max(1, MASK_CHUNK // (rows * 4 * groups))
    for e0 in range(0, len(items), step):
        e1 = min(e0 + step, len(items))
        words = philox4x32((c0, c1, c2[e0:e1], c3[e0:e1]), (seed, salt))
        bits = torch.stack(words, -1).reshape(e1 - e0, rows, 4 * groups)[..., :cols]
        out[e0:e1] = (bits < thr).float() * scale
    return out


def keep_mask(seed: int, salt: int, site: int, items: int, heads: int, rows: int,
              cols: int, rate: float, device=None, item0: int = 0,
              row0: int = 0) -> torch.Tensor:
    """(items, heads, rows, cols) float32 mask for the element (item0 + item,
    head, row0 + row, col) of `site`, as `keep_mask_entries` over every
    (item, head)."""
    entries = torch.arange(items * heads, device=device, dtype=torch.int64)
    mask = keep_mask_entries(seed, salt, site, (entries // heads + item0) & _MASK32,
                             entries % heads, rows, cols, rate, row0)
    return mask.reshape(items, heads, rows, cols)


def base_args(item0: int, row0: int) -> tuple[int, int]:
    """The C entry points' (item0, row0) after their dropout arguments: the
    call's first item and first row in the global batch, as uint32."""
    return int(item0) & _MASK32, int(row0) & _MASK32


def kernel_args(rate: float, seed, salt: int) -> tuple:
    """The C entry points' dropout arguments (seed, salt, thr, scale, on);
    off when `rate` is 0 or `seed` is None, as in the plain versions."""
    if rate <= 0.0 or seed is None:
        return (0, salt, 0, 1.0, 0)
    return (int(seed) & _MASK32, salt, keep_threshold(rate), keep_scale(rate), 1)
