"""Loading (`io.audio`, the decode threads) and the `.beats` writes
(`utils.save_beat_tsv`) with `after_each`: a group's wall time minus the
span around `BatchedFile2File._decode_group`, in ms per 1000 s of audio."""

from harness.readers import span_ms_per_ks


def read(ctx):
    group, decode = span_ms_per_ks(ctx, "group"), span_ms_per_ks(ctx, "decode_group")
    return None if group is None or decode is None else group - decode
