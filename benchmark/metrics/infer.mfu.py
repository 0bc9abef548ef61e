"""The whole forward: the operations of one forward of every chunk, and of
every short piece at its own length, that the reference's chunk rule lays
over the files the profiled window completed, over the window at the bf16
peak, in %. Padding the program adds is not counted as work."""

from harness.readers import mfu


def read(ctx):
    return mfu(ctx, 1) if ctx.cell.work_name == "audio_s" else None
