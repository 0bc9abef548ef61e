"""`inference.ChunkedPredictor` and `model` (the chunk planner, the
gathers, the forwards, the stitching): the span around
`predict_many_device`, in ms per 1000 s of audio."""

from harness.readers import span_ms_per_ks


def read(ctx):
    return span_ms_per_ks(ctx, "forward")
