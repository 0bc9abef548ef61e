"""`ops.mel`: the group's log-mel on the card, the span around
`BatchedFile2File._batched_spects_device`, in ms per 1000 s of audio."""

from harness.readers import span_ms_per_ks


def read(ctx):
    return span_ms_per_ks(ctx, "mel")
