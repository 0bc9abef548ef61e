"""The device in a training cell: the share of the profiled window in which
no kernel, copy or set ran on the card, in %."""

from harness.readers import idle_share


def read(ctx):
    return idle_share(ctx) if ctx.cell.work_name == "frames" else None
