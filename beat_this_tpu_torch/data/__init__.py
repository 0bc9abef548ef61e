"""Training data: the port's copy of beat_this_tpu/data/ (numpy only), kept
so that the port imports nothing of the JAX package."""

from beat_this_tpu_torch.data.dataset import (  # noqa: F401
    BeatDataModule,
    BeatTrackingDataset,
    prepare_annotations,
)
from beat_this_tpu_torch.data.mmnpz import MemmappedNpz  # noqa: F401
