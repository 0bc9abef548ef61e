"""The inputs made from a seed are the same for the same seed."""

import numpy as np
import torch

from conftest import SHORT_TRAIN, tiny_registry
from harness import audio, weights
from harness.training import Training


def test_audio_weights_and_durations_repeat_per_seed():
    spec = {"dist": "lognormal", "median_s": 210.0, "sigma": 0.45, "min_s": 30.0, "max_s": 600.0}
    d = audio.durations(spec, 32)
    assert d == audio.durations(spec, 32) and 30.0 <= min(d) and max(d) <= 600.0
    assert abs(np.median(d) - 210.0) < 10.0
    assert audio.durations({"dist": "fixed", "seconds": 30.0}, 3) == [30.0] * 3
    songs = [audio.song(3.0, torch.Generator().manual_seed(s), "cpu") for s in (5, 5, 6)]
    assert torch.equal(songs[0][0], songs[1][0]) and not torch.equal(songs[0][0], songs[2][0])
    assert np.array_equal(songs[0][1], songs[1][1])
    cfg = {"spect_dim": 128, "transformer_dim": 64, "ff_mult": 4, "n_layers": 1,
           "head_dim": 32, "stem_dim": 32, "partial_transformers": True}
    big = 2**31 + 12345  # seeds wider than 32 bits
    a, b = weights.make_state(cfg, big, "cpu"), weights.make_state(cfg, big, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = weights.make_state(cfg, big + 1, "cpu")
    assert not torch.equal(a["frontend.linear.weight"], c["frontend.linear.weight"])


def test_training_batches_repeat_per_seed_and_step(tmp_path):
    reg = tiny_registry(tmp_path, {"train_bf16": SHORT_TRAIN})
    cfg, traffic = reg.config("final"), reg.traffic("train_bf16")
    cells = [Training(cfg, traffic, s, "cpu", tmp_path) for s in (2**33 + 1, 2**33 + 1, 7)]
    for cell in cells:
        cell._corpus()
    x, y, z = (c.batch(3) for c in cells)
    assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(x["spect"], z["spect"])
    assert not torch.equal(x["spect"], cells[0].batch(4)["spect"])
    crops = x["spect"].reshape(-1, *x["spect"].shape[2:])
    assert len({c.sum().item() for c in crops}) == len(crops)  # rows all differ
