"""K3, the eval frequency block (`csrc/fused_freq.cu`, one launch): x +
gated rotary attention over the F frequency bins of each frame, then the
feed-forward residual; the frontend's three frequency blocks."""

from harness import geometry

NAMES = (r"freq_block_kernel",)
ANCHOR = r"freq_block_kernel"
COUNTERS = (("beat_this_tpu_torch.ops.fused_freq", "fused_freq_roformer"),)


def calls(cfg, forwards):
    return [(items, seq, c, mult) for rows, frames, _ in forwards
            for kind, items, seq, c, mult in geometry.blocks(cfg, rows, frames)
            if kind == "freq"]


def work(call, act_bytes):
    items, seq, c, mult = call
    rows = items * seq
    flops = geometry.attention_flops(items, seq, c) + geometry.ff_flops(rows, c, mult)
    weights = geometry.attention_weights(c) + geometry.ff_weights(c, mult)
    return flops, 2 * rows * c * act_bytes + 4 * weights
