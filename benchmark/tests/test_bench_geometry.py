"""The work models against counts made by hand at small shapes."""

import json
from types import SimpleNamespace

import pytest

from conftest import HERE
from harness import geometry, readers
from reference import chunks
from harness.registry import load_module


def cfg(name="final"):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_attention_and_ff_counts_by_hand():
    # 2 items of 4 rows, C 64 (2 heads of 32): q/k/v 64 -> 192, gates
    # 64 -> 2, out 64 -> 64; scores and values 2 x (4 x 4 x 32) per head
    rows = 2 * 4
    proj = 2 * rows * 64 * 192 + 2 * rows * 64 * 2 + 2 * rows * 64 * 64
    core = 2 * 2 * (2 * 4 * 4 * 32) * 2
    assert geometry.attention_flops(2, 4, 64) == proj + core
    assert geometry.ff_flops(rows, 64, 4) == 2 * rows * 64 * 256 * 2
    assert geometry.attention_weights(64) == 192 * 64 + 2 * 64 + 2 + 64 * 64 + 64
    assert geometry.ff_weights(64, 4) == 256 * 64 + 256 + 64 * 256 + 64 + 64


def test_blocks_follow_the_published_geometry():
    b = geometry.blocks(cfg(), 2, 10)
    assert b[:6] == [("freq", 20, 32, 32, 4), ("time", 64, 10, 32, 4),
                     ("freq", 20, 16, 64, 4), ("time", 32, 10, 64, 4),
                     ("freq", 20, 8, 128, 4), ("time", 16, 10, 128, 4)]
    assert b[6:] == [("main", 2, 10, 512, 4)] * 6


def test_forward_flops_by_hand():
    c = cfg("small")
    n = 3 * 7
    total = 2 * n * 32 * 32 * 12  # stem: 32 bins x 32 channels, 4 x 3 taps
    for kind, items, seq, ch, mult in geometry.blocks(c, 3, 7):
        total += geometry.attention_flops(items, seq, ch) + geometry.ff_flops(items * seq, ch, mult)
    for f, ch in ((32, 32), (16, 64), (8, 128)):
        total += 2 * n * (f // 2) * (2 * ch) * (ch * 2 * 3)
    total += 2 * n * 1024 * 128 + 2 * n * 128 * 2
    assert geometry.forward_flops(c, 3, 7) == total


def test_family_work_counts_each_byte_once():
    k2 = load_module(HERE / "work" / "k2.py")
    calls = k2.calls(cfg(), [(2, 1500, False), (5, 768, True)])
    assert len(calls) == 3 + 6  # the masked forward takes no K2
    flops, nbytes = k2.work((16, 1500, 512, 4), 4)
    rows = 16 * 1500
    assert flops == geometry.attention_flops(16, 1500, 512) + geometry.ff_flops(rows, 512, 4)
    assert nbytes == 2 * rows * 512 * 4 + 4 * (geometry.attention_weights(512)
                                               + geometry.ff_weights(512, 4))
    b5 = load_module(HERE / "work" / "b5.py")
    assert len(b5.calls(cfg(), [(8, 1500, False)] * 8)) == 8 * 9
    b9 = load_module(HERE / "work" / "b9.py")
    assert len(b9.calls(cfg(), [(8, 1500, False)])) == 12  # B9 9, B7's half 3
    flops, _ = b9.work((12000, 512, 4), 2)
    assert flops == 2 * geometry.ff_flops(12000, 512, 4)


def test_mfu_counts_the_reference_chunk_rule_not_the_padding():
    # a 10 s clip (501 frames) runs at its own length plus borders, though
    # the program pads it to the 768-frame bucket; a 30 s piece (1501
    # frames) runs as two chunks of 1500
    assert chunks.own_windows(501) == [513]
    assert chunks.own_windows(1501) == [1500, 1500]
    c = cfg()
    ctx = SimpleNamespace(cell=SimpleNamespace(cfg=c), trace=SimpleNamespace(window_s=0.5),
                          peaks={"bf16_dense_flops_per_s": 989e12},
                          model_work=[(1, w) for w in chunks.own_windows(501)
                                      + chunks.own_windows(1501)])
    want = geometry.forward_flops(c, 1, 513) + 2 * geometry.forward_flops(c, 1, 1500)
    assert readers.mfu(ctx, 1) == pytest.approx(100 * want / (0.5 * 989e12))
    assert readers.mfu(ctx, 3) == pytest.approx(3 * readers.mfu(ctx, 1))
    ctx.model_work = []
    assert readers.mfu(ctx, 1) is None
