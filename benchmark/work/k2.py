"""K2, the eval time block (`csrc/fused_time.cu`): x + gated rotary
attention, then the feed-forward residual, over (items, n, C) on the time
axis; the frontend's time blocks and the main layers of an unmasked
forward. Its feed-forward launches are B8's kernels, which K1 also runs:
the family is read only in a window where K1 did not launch."""

from harness import geometry

NAMES = (r"time_rows_kernel", r"time_qkv_kernel", r"attn_fwd_kernel", r"time_out_kernel",
         r"operands_kernel", r"ff_pre_kernel", r"ff_hidden_kernel", r"ff_out_kernel",
         r"ff_product_kernel", r"ff_out_sum_kernel")
ANCHOR = r"time_out_kernel"  # one launch per call
COUNTERS = (("beat_this_tpu_torch.ops.fused_time", "fused_time_roformer"),)
EXCLUSIVE = (("beat_this_tpu_torch.ops.fused_ff", "fused_ff"),)


def calls(cfg, forwards):
    """(items, n, C, ff_mult) of every call in forwards (rows, frames,
    masked); a masked forward takes the plain attention, not K2."""
    return [(items, seq, c, mult) for rows, frames, masked in forwards if not masked
            for kind, items, seq, c, mult in geometry.blocks(cfg, rows, frames)
            if kind in ("time", "main")]


def work(call, act_bytes):
    """(operations, bytes): x read and the output written once, the float32
    weights read once."""
    items, seq, c, mult = call
    rows = items * seq
    flops = geometry.attention_flops(items, seq, c) + geometry.ff_flops(rows, c, mult)
    weights = geometry.attention_weights(c) + geometry.ff_weights(c, mult)
    return flops, 2 * rows * c * act_bytes + 4 * weights
