"""B9 (`csrc/ff_train.cuh`'s backward, with B7's feed-forward half): its
share of its roofline in the profiled window (`work/b9.py`)."""

from harness.readers import roofline


def read(ctx):
    return roofline(ctx, "b9")
