"""B5 (`csrc/fused_time_train.cu`'s backward): its share of its roofline in
the profiled window (`work/b5.py`)."""

from harness.readers import roofline


def read(ctx):
    return roofline(ctx, "b5")
