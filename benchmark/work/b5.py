"""B5, the training backward of the time-axis attention branch
(`csrc/fused_time_train.cu`, `attn_train_bwd`): the frontend's time blocks
and the main layers of every microbatch. Its work is twice the forward's
products (each product's two operand gradients); x, the output's gradient
and x's gradient are moved once, the float32 weights read and their
gradients written once. The shared operand conversions are not its own."""

from harness import geometry

NAMES = (r"attn_bwd_pre_kernel", r"attn_dgo_kernel", r"attn_dq_kernel", r"attn_dkv_kernel",
         r"attn_product_kernel", r"attn_bwd_post_kernel", r"attn_bwd_sums_kernel")
ANCHOR = r"attn_bwd_sums_kernel"  # one launch per call
COUNTERS = (("beat_this_tpu_torch.ops.fused_time", "attn_train_bwd"),)


def calls(cfg, forwards):
    return [(items, seq, c) for crops, frames, _ in forwards
            for kind, items, seq, c, _ in geometry.blocks(cfg, crops, frames)
            if kind in ("time", "main")]


def work(call, act_bytes):
    items, seq, c = call
    return (2 * geometry.attention_flops(items, seq, c),
            3 * items * seq * c * act_bytes + 8 * geometry.attention_weights(c))
