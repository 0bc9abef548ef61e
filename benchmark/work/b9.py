"""B9, the feed-forward training backward (`csrc/ff_train.cuh`,
`ff_train_bwd`), with the frequency block's feed-forward half of B7, which
runs the same kernels: every feed-forward of every microbatch. Its work is
twice the forward's products; x, the output's gradient and x's gradient
are moved once, the float32 weights read and their gradients written
once."""

from harness import geometry

NAMES = (r"ff_pre_kernel<[^>]*, true, \d+>", r"ff_hidden_kernel<\d+, true>",
         r"ff_product_kernel", r"ff_post_kernel", r"column_sums")
ANCHOR = r"ff_post_kernel"  # one launch per call
COUNTERS = (("beat_this_tpu_torch.ops.fused_ff", "ff_train_bwd"),
            ("beat_this_tpu_torch.ops.fused_freq", "freq_train_bwd"))


def calls(cfg, forwards):
    return [(items * seq, c, mult) for crops, frames, _ in forwards
            for _, items, seq, c, mult in geometry.blocks(cfg, crops, frames)]


def work(call, act_bytes):
    rows, c, mult = call
    return (2 * geometry.ff_flops(rows, c, mult),
            3 * rows * c * act_bytes + 8 * geometry.ff_weights(c, mult))
