from beat_this_tpu_torch.postprocessing.postprocessor import (  # noqa: F401
    Postprocessor,
    deduplicate_peaks,
)
