"""`train.task`'s AdamW step and schedule: the span around the optimizer's
`step` in the traced window, in ms per optimizer step."""


def read(ctx):
    if "optimizer" not in ctx.span_s or not ctx.units:
        return None
    return 1e3 * ctx.span_s["optimizer"] / ctx.units
