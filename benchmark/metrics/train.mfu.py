"""The whole training step: three forwards' operations per crop of every
microbatch the profiled window ran, over the window at the bf16 peak, in %."""

from harness.readers import mfu


def read(ctx):
    return mfu(ctx, 3) if ctx.cell.work_name == "frames" else None
