"""The model's published geometry as operation counts: the roformer blocks
one forward runs, and the products each takes. Counts are of the work the
shapes need, each multiply-add two operations, whatever a kernel splits or
recomputes; the norms, softmax and activations are not counted."""

from __future__ import annotations

HEAD_DIM = 32


def blocks(cfg: dict, rows: int, frames: int) -> list[tuple]:
    """(kind, items, seq, C, ff_mult) of every roformer block of one forward
    of `rows` x `frames`: the frontend's frequency ("freq") and time
    ("time") blocks, then the main ("main") layers."""
    out, f = [], cfg["spect_dim"] // 4
    for i in range(3):
        c = cfg["stem_dim"] * 2**i
        if cfg["partial_transformers"]:
            out.append(("freq", rows * frames, f, c, 4))
            out.append(("time", rows * f, frames, c, 4))
        f //= 2
    out += [("main", rows, frames, cfg["transformer_dim"], cfg["ff_mult"])] * cfg["n_layers"]
    return out


def attention_flops(items: int, seq: int, c: int) -> int:
    """q/k/v, gates and out projections, and the score and value products."""
    heads = c // HEAD_DIM
    return 2 * items * seq * c * (4 * c + heads) + 4 * items * heads * seq * seq * HEAD_DIM


def ff_flops(rows: int, c: int, mult: int) -> int:
    return 4 * rows * c * mult * c


def attention_weights(c: int) -> int:
    heads = c // HEAD_DIM
    return 4 * c * c + heads * c + heads + c


def ff_weights(c: int, mult: int) -> int:
    return 2 * mult * c * c + mult * c + 2 * c


def forward_flops(cfg: dict, rows: int, frames: int) -> int:
    """Every product of one forward: stem, blocks, convolutions, the
    projection and the head."""
    n = rows * frames
    f, stem = cfg["spect_dim"] // 4, cfg["stem_dim"]
    total = 2 * n * f * stem * 12
    for kind, items, seq, c, mult in blocks(cfg, rows, frames):
        total += attention_flops(items, seq, c) + ff_flops(items * seq, c, mult)
    for i in range(3):
        c = stem * 2**i
        total += 2 * n * (f // 2) * (2 * c) * (c * 6)
        f //= 2
    concat = stem * 8 * (cfg["spect_dim"] // 32)
    return total + 2 * n * concat * cfg["transformer_dim"] + 2 * n * cfg["transformer_dim"] * 2


def act_bytes(traffic: dict) -> int:
    return 2 if traffic["precision"] == "bfloat16" else 4
