"""K3 (`csrc/fused_freq.cu`): its share of its roofline in the profiled
window (`work/k3.py`)."""

from harness.readers import roofline


def read(ctx):
    return roofline(ctx, "k3")
