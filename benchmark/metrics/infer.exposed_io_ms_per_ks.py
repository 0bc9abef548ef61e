"""Host I/O that the card's work does not hide, in a directory cell: the
harness's range around one `process_many` call over a pass minus its
wrappers of `BatchedFile2File._decode_group` (each group's log-mel,
forwards and postprocess, ending in a synchronize in the traced window),
in ms per 1000 s of audio. What is left is the loading, the `.beats`
writes and `after_each` that ran while no group's device work did; loading
the next group while the card runs this one shrinks it."""

from harness.readers import span_ms_per_ks


def read(ctx):
    call, decode = span_ms_per_ks(ctx, "call"), span_ms_per_ks(ctx, "decode_group")
    return None if call is None or decode is None else call - decode
