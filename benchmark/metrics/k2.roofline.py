"""K2 (`csrc/fused_time.cu`): its share of its roofline in the profiled
window (`work/k2.py`)."""

from harness.readers import roofline


def read(ctx):
    return roofline(ctx, "k2")
