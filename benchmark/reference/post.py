"""The minimal postprocessor of Beat This! (beat_this/model/postprocessor.py:
90-136) and the `.beats` reader: logits to beat and downbeat times."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

FPS = 50


def peaks(logits: np.ndarray) -> np.ndarray:
    """Frames that equal the maximum over +/- 3 frames and lie above 0."""
    x = torch.from_numpy(np.asarray(logits, np.float32))[None, None]
    pooled = F.max_pool1d(x, 7, stride=1, padding=3)
    return torch.nonzero(((x == pooled) & (x > 0))[0, 0]).flatten().numpy()


def dedup(frames: np.ndarray, width: float = 1.0) -> np.ndarray:
    """Collapse peaks closer than `width` into the mean of their cluster:
    a new cluster starts where a peak lies more than `width` past the
    running mean of the open one."""
    out, acc, n = [], 0.0, 0
    for q in np.asarray(frames, np.float64):
        if n and q * n - acc > width * n:
            out.append(acc / n)
            acc, n = 0.0, 0
        acc += q
        n += 1
    if n:
        out.append(acc / n)
    return np.asarray(out, np.float64)


def beats(beat_logits, downbeat_logits) -> tuple[np.ndarray, np.ndarray]:
    """(beat times, downbeat times) in seconds: every downbeat snapped to
    its nearest beat, duplicates removed."""
    beat_t = dedup(peaks(beat_logits)) / FPS
    down_t = dedup(peaks(downbeat_logits)) / FPS
    if len(beat_t):
        down_t = np.array([beat_t[np.argmin(np.abs(beat_t - d))] for d in down_t])
    return beat_t, np.unique(down_t)


def read_beats(text: str) -> tuple[np.ndarray, np.ndarray]:
    """(beat times, downbeat times) of a `.beats` file's text: one
    `time<TAB>number` row per beat, number 1 at a downbeat."""
    rows = [line.split("\t") for line in text.splitlines() if line.strip()]
    times = np.array([float(r[0]) for r in rows], np.float64)
    numbers = np.array([int(r[1]) for r in rows], np.int64)
    return times, times[numbers == 1]
