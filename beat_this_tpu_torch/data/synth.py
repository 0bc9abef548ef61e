"""Synthetic beat-tracking corpora for smoke and convergence testing.

Writes the same on-disk layout the real data pipeline consumes
(annotations/<ds>/..., audio/spectrograms/<ds>.npz — reference layout:
beat_this/dataset/dataset.py:37-80) but with procedurally generated
spectrograms whose beat positions are *visible in the features*: every beat
frame carries a broadband energy burst, and downbeat frames an extra
low-band boost. A model that learns anything at all can drive its training
F-measure to ~1.0 on such a corpus, which makes it the substrate for the
end-to-end "does the trainer actually learn?" checks
(tests/test_overfit.py, launch_scripts/overfit_smoke.py) — the role
torchvision's FakeData plays for image stacks.

The port's copy of beat_this_tpu/data/synth.py, kept so that the port imports nothing of
the JAX package; the tests hold the two to identical results.
"""

from __future__ import annotations

import json

import numpy as np

from beat_this_tpu_torch.data.mmnpz import write_npz


def click_track(
    n_frames: int,
    interval: int,
    phase: int,
    meter: int,
    rng: np.random.Generator,
    n_mels: int = 128,
    beat_gain: float = 4.0,
    noise: float = 0.5,
):
    """One synthetic piece: (spect float16 (n_frames, n_mels), beat_frames,
    beat_values). Beats every `interval` frames starting at `phase`; beat
    counting cycles 1..meter starting on a downbeat."""
    spect = (rng.standard_normal((n_frames, n_mels)) * noise).astype(np.float32)
    beat_frames = np.arange(phase, n_frames - 2, interval)
    beat_values = (np.arange(len(beat_frames)) % meter) + 1
    for f, v in zip(beat_frames, beat_values):
        spect[f] += beat_gain
        if v == 1:  # downbeats: extra energy in the low mel bands
            spect[f, : n_mels // 4] += beat_gain
    return spect.astype(np.float16), beat_frames, beat_values


def write_click_corpus(
    root,
    n_pieces: int = 4,
    n_val_pieces: int = 1,
    frames: int = 520,
    dataset: str = "click",
    fps: int = 50,
    seed: int = 0,
    beat_gain: float = 4.0,
) -> list[str]:
    """Write a click-track corpus under `root`; returns the train item ids.

    Each piece gets its own beat interval (20..interval+3*i frames) and
    phase so the model must read the features rather than memorize a single
    grid. Validation pieces follow the training pieces in the split file.
    """
    ann = root / "annotations" / dataset
    (ann / "annotations" / "beats").mkdir(parents=True, exist_ok=True)
    (ann / "info.json").write_text(json.dumps({"has_downbeats": True}))
    spect_dir = root / "audio" / "spectrograms"
    spect_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    bundle, split_rows, train_items = {}, [], []
    for i in range(n_pieces + n_val_pieces):
        piece = f"click{i}"
        spect, beat_frames, beat_values = click_track(
            n_frames=frames,
            interval=20 + 3 * (i % 4),
            phase=4 + 2 * i,
            meter=4,
            rng=rng,
            beat_gain=beat_gain,
        )
        bundle[f"{piece}/track"] = spect
        times = beat_frames / fps
        np.savetxt(
            ann / "annotations" / "beats" / f"{piece}.beats",
            np.stack([times, beat_values], 1),
            fmt="%.3f\t%d",
        )
        role = "train" if i < n_pieces else "val"
        split_rows.append(f"{piece}\t{role}")
        if role == "train":
            train_items.append(f"{dataset}/{piece}")
    (ann / "single.split").write_text("\n".join(split_rows) + "\n")
    write_npz(spect_dir / f"{dataset}.npz", bundle)
    return train_items
