"""Dropout at global batch coordinates (`ops/dropout.py`: item0, row0) in the
plain versions of the training ops, on the CPU: run on a shard of a batch
(items LO .. LO + SHARD - 1) with the shard's item0, an op draws exactly
those items' rows of the masks it draws on the whole batch, and gives
those items' rows of the whole batch's output; on the whole batch (base 0)
it draws the bits it drew before the bases existed (the digests, taken from
the plain versions without them).

Every mask flows through `keep_mask_entries`; each case records what it
returns. Sites: the time-axis branch's probabilities and output
(`fused_time_attention_train_ref`; `attention_block`'s rotation-and-sdpa
route), the feed-forward's hidden and output sites (`fused_ff_train_ref`),
the frequency block's four (`fused_freq_roformer_train_ref`), and the
probabilities of `flash_attention_ref` and `small_attention_ref`
(`probs_keep`).
"""

import hashlib

import numpy as np
import pytest
import torch

from beat_this_tpu_torch.model import layers
from beat_this_tpu_torch.model.layers import Attention, FeedForward
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops import flash_attention as flash_ops
from beat_this_tpu_torch.ops import small_attention as small_ops
from beat_this_tpu_torch.ops.fused_ff import fused_ff_train_ref
from beat_this_tpu_torch.ops.fused_freq import fused_freq_roformer_train_ref
from beat_this_tpu_torch.ops.fused_time import fused_time_attention_train_ref
from beat_this_tpu_torch.ops.rotary import rope_tables

SEED, RATE = 17, 0.5
ITEMS, LO, SHARD = 5, 2, 2  # the batch's items, the shard's first item and its items


def _modules(c, heads, head_dim=32):
    rng = np.random.default_rng(c + heads + head_dim)
    attn, ff = Attention(c, heads, head_dim), FeedForward(c)
    with torch.no_grad():
        for p in list(attn.parameters()) + list(ff.parameters()):
            scale = p.shape[-1] ** -0.5 if p.ndim == 2 else 0.1
            p.copy_(torch.from_numpy((scale * rng.standard_normal(p.shape)).astype(np.float32)))
    return attn, ff


def _x(seed, *shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _case(name):
    """(op(inputs, **kw), inputs of the whole batch, entries per item): the
    op's leading axis holds `entries per item` entries of each item."""
    if name == "time_branch":
        attn, _ = _modules(64, 2)
        cos, sin = rope_tables(24, 32)
        return (lambda x, **kw: fused_time_attention_train_ref(x, attn, cos, sin, 2, RATE, SEED,
                                                               **kw),
                (_x(1, ITEMS, 24, 64),), 1)
    if name == "attention_block":
        attn, _ = _modules(32, 2, 16)
        rope = rope_tables(24, 16)
        return (lambda x, **kw: layers.attention_block(attn, x, rope, 2, dropout_rate=RATE,
                                                       seed=SEED, kernels=False, **kw),
                (_x(2, ITEMS, 24, 32),), 1)
    if name == "ff":
        _, ff = _modules(32, 1)
        return (lambda x, **kw: fused_ff_train_ref(x, ff, RATE, SEED, **kw),
                (_x(3, ITEMS, 6, 32),), 1)
    if name == "freq_block":
        attn, ff = _modules(64, 2)
        cos, sin = rope_tables(8, 32)
        return (lambda x, **kw: fused_freq_roformer_train_ref(x, attn, ff, cos, sin, RATE, SEED,
                                                              **kw),
                (_x(4, ITEMS, 8, 64),), 1)
    heads, n, ref = (3, 40, flash_ops.flash_attention_ref) if name == "flash" else (
        4, 8, small_ops.small_attention_ref)
    cos, sin = rope_tables(n, 16)
    qkv = tuple(_x(5 + i, ITEMS * heads, n, 16) for i in range(3))
    return (lambda q, k, v, **kw: ref(q, k, v, cos, sin, RATE, SEED, heads, **kw), qkv, heads)


CASES = ["time_branch", "attention_block", "ff", "freq_block", "flash", "small"]
# sha256 of the whole batch's masks (float32, in the order drawn) on the
# tree before the batch bases
DIGESTS = {
    "time_branch":
        "b9ef5466c6e0414ace6d6ff208d93ddedd57c4fdccc52e08707c70d1f7b64c06",
    "attention_block":
        "af2ff98c549cb80c3edff10978cc997c0386561f768b04a2cb47ee4dc64bc5df",
    "ff":
        "808e75ac9e50c05208554d024e2dfc653241d1d3f432a32ab48b8581bbd2131b",
    "freq_block":
        "caaa9c5f02f3bc1bbadd9a5291232730f06d65c27f8498a5f17b4f099b80a391",
    "flash":
        "4b734a146d98094f8e182793f0ccceee98d694ea1415d20041354a56c39aa9eb",
    "small":
        "8a4abe2e7c7c5e5d6462587f11bf4b355e8c373a50b8f899c43173cfd19b2e45",
}


def _draw(monkeypatch, op, inputs, **kw):
    """The op's output and the masks it drew."""
    masks = []
    real = drop.keep_mask_entries

    def recording(*args, **kwargs):
        masks.append(real(*args, **kwargs))
        return masks[-1]

    monkeypatch.setattr(drop, "keep_mask_entries", recording)
    with torch.no_grad():
        out = op(*inputs, **kw)
    monkeypatch.setattr(drop, "keep_mask_entries", real)
    return out, masks


def digest(masks) -> str:
    h = hashlib.sha256()
    for m in masks:
        h.update(m.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", CASES)
def test_a_shard_draws_its_rows_of_the_batch_masks(monkeypatch, name):
    op, inputs, per = _case(name)
    out, masks = _draw(monkeypatch, op, inputs)
    assert masks and digest(masks) == DIGESTS[name]
    zero_out, zero_masks = _draw(monkeypatch, op, inputs, item0=0)
    assert torch.equal(zero_out, out) and digest(zero_masks) == DIGESTS[name]

    shard = [t[LO * per : (LO + SHARD) * per] for t in inputs]
    got, got_masks = _draw(monkeypatch, op, shard, item0=LO)
    assert len(got_masks) == len(masks)
    for g, m in zip(got_masks, masks):
        flat, whole = g.reshape(-1), m.reshape(-1)
        per_item = len(whole) // ITEMS
        assert torch.equal(flat, whole[LO * per_item : (LO + SHARD) * per_item])
    torch.testing.assert_close(got, out[LO * per : (LO + SHARD) * per], rtol=1e-5, atol=1e-6)
    # a shard that kept base 0 would draw the batch's first items' bits instead
    wrong, _ = _draw(monkeypatch, op, shard)
    assert not torch.allclose(wrong, got, rtol=1e-3, atol=1e-3)
