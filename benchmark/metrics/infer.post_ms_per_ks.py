"""`postprocessing`: the span around `frames2beats`, in ms per 1000 s of
audio."""

from harness.readers import span_ms_per_ks


def read(ctx):
    return span_ms_per_ks(ctx, "post")
