from beat_this_tpu_torch.model.beat_this import BeatThis, BeatThisConfig  # noqa: F401
