"""Training of the PyTorch port: losses, schedule, train step, trainer and the
driver (`python -m beat_this_tpu_torch.train`), counterpart of
beat_this_tpu/train/ and launch_scripts/train.py."""
