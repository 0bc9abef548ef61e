"""Dropout keep masks as the program states them: Philox4x32-10 (Salmon et
al., SC 2011) keyed by (seed, salt), with the counter (col // 4, row, item,
site << 16 | head); a column reads word col % 4 of its counter's output.
An element is kept iff its 32 bits are below ceil((1 - rate) * 2**32), and a
kept element is scaled by 1 / (1 - rate) rounded to float32. The mask is a
function of an element's coordinates only, so the reference draws the
program's masks again from the seed.

The 32-bit products are taken as one int64 product: it wraps modulo 2**64,
whose low 64 bits hold both 32-bit words exactly.
"""

from __future__ import annotations

import math

import torch

SITE_ATTN_PROBS, SITE_ATTN_OUT, SITE_FF_HIDDEN, SITE_FF_OUT = 0, 1, 2, 3
SALT_ATTN, SALT_FF, SALT_FREQ = 0x7A77, 0x0FF0, 0xF4E9
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
CHUNK = 1 << 26  # elements per drawn chunk: bounds the int64 temporaries


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """The four output words of Philox4x32-10 (int64 tensors of uint32
    values, broadcast)."""
    k0, k1 = k0 & _MASK, k1 & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        p0 = c0 * _M0
        p1 = c2 * _M1
        hi0, lo0 = (p0 >> 32) & _MASK, p0 & _MASK
        hi1, lo1 = (p1 >> 32) & _MASK, p1 & _MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(seed: int, salt: int, site: int, items: int, heads: int, rows: int, cols: int,
              rate: float, device, item0: int = 0, row0: int = 0) -> torch.Tensor:
    """(items, heads, rows, cols) bool mask of the kept elements (item0 +
    item, head, row0 + row, col) of `site`."""
    thr = min(math.ceil((1.0 - rate) * 2**32), _MASK)
    groups = -(-cols // 4)
    i64 = dict(device=device, dtype=torch.int64)
    c0 = torch.arange(groups, **i64)
    c1 = ((torch.arange(rows, **i64) + row0) & _MASK)[:, None]
    out = torch.empty((items * heads, rows, cols), dtype=torch.bool, device=device)
    step = max(1, CHUNK // (rows * 4 * groups))
    entries = torch.arange(items * heads, **i64)
    for e0 in range(0, items * heads, step):
        e = entries[e0 : e0 + step]
        c2 = ((e // heads + item0) & _MASK)[:, None, None]
        c3 = ((site << 16) | (e % heads))[:, None, None]
        words = philox(c0, c1, c2, c3, seed, salt)
        bits = torch.stack(words, -1).reshape(len(e), rows, 4 * groups)[..., :cols]
        out[e0 : e0 + len(e)] = bits < thr
    return out.reshape(items, heads, rows, cols)


def keep_scale(rate: float) -> float:
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def rows_keep(seed: int, salt: int, site: int, shape, rate: float, device,
              row0: int = 0) -> torch.Tensor:
    """float32 keep factors over a tensor of `shape` viewed as (rows, C)."""
    rows = math.prod(shape[:-1])
    m = keep_mask(seed, salt, site, 1, 1, rows, shape[-1], rate, device, row0=row0)
    return m.reshape(shape).float() * keep_scale(rate)
