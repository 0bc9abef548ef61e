"""Data augmentation.

Pitch and tempo augmentation are *precomputed file swaps* exactly as in the
reference (beat_this/dataset/augment.py:5-126): the dataset pipeline has
rendered ``track_ps{n}.npy`` / ``track_ts{n}.npy`` spectrogram variants
offline; at training time one of pitch/tempo is chosen 50/50 and a random
factor selects the file, with beat times divided by the tempo factor. Mask
augmentation operates in-memory on the excerpt: 1-6 regions of 0.1-2 s are
either zeroed or cut into 5-9 parts that are shuffled
(beat_this/dataset/augment.py:129-201).

All randomness flows through an explicit numpy Generator for reproducible,
seedable input pipelines (no global RNG state).

The port's copy of beat_this_tpu/data/augment.py, kept so that the port imports nothing of
the JAX package; the tests hold the two to identical results.
"""

from __future__ import annotations

from pathlib import PurePosixPath

import numpy as np


def augment_pitchtempo(item: dict, augmentations: dict, rng: np.random.Generator):
    """Pick one of pitch/tempo augmentation (50/50 when both are enabled) and
    rewrite the spectrogram path / annotations accordingly."""
    if "pitch" in augmentations and "tempo" in augmentations:
        if rng.integers(2) == 0:
            item = _augment_pitch(item, augmentations["pitch"], rng)
        else:
            item = _augment_tempo(item, augmentations["tempo"], rng)
    elif "pitch" in augmentations:
        item = _augment_pitch(item, augmentations["pitch"], rng)
    elif "tempo" in augmentations:
        item = _augment_tempo(item, augmentations["tempo"], rng)
    return item


def _augment_pitch(item, params, rng):
    semitones = int(rng.integers(params["min"], params["max"] + 1))
    if semitones:
        p = PurePosixPath(str(item["spect_path"]))
        item = {**item, "spect_path": str(p.with_name(f"{p.stem}_ps{semitones}{p.suffix}"))}
    return item


def _augment_tempo(item, params, rng):
    choices = np.arange(params["min"], params["max"] + 1, params["stride"])
    percentage = int(rng.choice(choices))
    if percentage:
        p = PurePosixPath(str(item["spect_path"]))
        item = {
            **item,
            "spect_path": str(p.with_name(f"{p.stem}_ts{percentage}{p.suffix}")),
            # percentage is the tempo change; annotations shrink accordingly
            "beat_time": item["beat_time"] / (1.0 + percentage / 100),
        }
    return item


def precomputed_augmentation_filenames(augmentations: dict, ext: str = "npy"):
    """All spectrogram files an item must provide for the given augmentations
    (reference augment.py:105-126)."""
    filenames = [f"track.{ext}"]
    for method, params in augmentations.items():
        if method == "pitch":
            for semitones in range(params["min"], params["max"] + 1):
                if semitones:
                    filenames.append(f"track_ps{semitones}.{ext}")
        elif method == "tempo":
            for percentage in range(params["min"], params["max"] + 1, params["stride"]):
                if percentage:
                    filenames.append(f"track_ts{percentage}.{ext}")
    return filenames


def augment_mask_(
    spect: np.ndarray, augmentations: dict, fps: int, rng: np.random.Generator
) -> np.ndarray:
    """Apply in-place mask augmentation to a (time, mels) excerpt."""
    if "mask" not in augmentations:
        return spect
    params = augmentations["mask"]
    count = int(rng.integers(params["min_count"], params["max_count"] + 1))
    min_len = int(params["min_len"] * fps)
    max_len = int(params["max_len"] * fps)
    for _ in range(count):
        length = int(rng.integers(min_len, max_len + 1))
        if length >= len(spect):
            continue
        start = int(rng.integers(0, len(spect) - length))
        apply_mask_excerpt(
            spect[start : start + length],
            params["kind"],
            params.get("min_parts", 5),
            params.get("max_parts", 9),
            rng,
        )
    return spect


def apply_mask_excerpt(excerpt, kind, min_parts, max_parts, rng):
    if kind == "permute":
        num_parts = int(rng.integers(min_parts, max_parts + 1))
        num_parts = min(num_parts, len(excerpt) + 1)
        positions = np.sort(rng.choice(len(excerpt), num_parts - 1, replace=False))
        parts = np.split(excerpt, positions)
        order = rng.permutation(num_parts)
        excerpt[:] = np.concatenate([parts[i] for i in order])
    elif kind == "zero":
        excerpt[:] = 0
    else:
        raise ValueError(f"Unsupported mask operation: {kind}")
