"""Synthetic music made on the device from a seed: percussive clicks at a
tempo of 60-180 BPM (every fourth, the downbeat, louder and higher), a
sustained tone with its octave, and noise; and the 22050 Hz mono 16-bit
wav files that the reference's `preprocess_audio` writes.

Durations are fixed quantiles of the traffic's distribution, so every seed
runs the same audio lengths; the seed draws the music."""

from __future__ import annotations

import math
import os
import statistics
import wave
from pathlib import Path

import numpy as np
import torch

SR, FPS = 22050, 50


def durations(spec: dict, count: int) -> list[float]:
    """`count` durations (s): all `seconds` long ("fixed", as a dataset of
    clips of one length), or at the quantiles (i + 0.5) / count of a
    "lognormal" (median_s, sigma) or "loguniform" distribution, clipped to
    [min_s, max_s]."""
    if spec["dist"] == "fixed":
        return [float(spec["seconds"])] * count
    qs = [(i + 0.5) / count for i in range(count)]
    lo, hi = spec["min_s"], spec["max_s"]
    if spec["dist"] == "lognormal":
        norm = statistics.NormalDist()
        out = [spec["median_s"] * math.exp(spec["sigma"] * norm.inv_cdf(q)) for q in qs]
    elif spec["dist"] == "loguniform":
        out = [lo * (hi / lo) ** q for q in qs]
    else:
        raise ValueError(f"unknown duration distribution {spec['dist']!r}")
    return [min(max(d, lo), hi) for d in out]


def song(seconds: float, gen: torch.Generator, device) -> tuple[torch.Tensor, np.ndarray]:
    """(int16 samples, beat frames, downbeat frames) of one synthetic
    piece; the frames are the first frame after each onset."""
    n = int(seconds * SR)
    u = torch.rand(5, generator=gen, device=device, dtype=torch.float64).tolist()
    period = 60.0 / (60.0 + 120.0 * u[0])
    phase = u[1] * period
    f0 = 110.0 * 4.0 ** u[2]
    t = torch.arange(n, device=device, dtype=torch.float64) / SR
    k = torch.floor((t - phase) / period)
    local = (t - phase - k * period).float()
    down = (k.remainder(4) == 0).float()
    env = torch.exp(-local / 0.02) * (k >= 0).float()
    tt = t.float()
    noise = torch.randn(n, generator=gen, device=device)
    click = env * (0.5 + 0.5 * down) * (0.5 * noise + torch.sin(2 * math.pi * (1000.0 + 500.0 * down) * local))
    tone = (0.08 + 0.04 * u[3]) * (torch.sin(2 * math.pi * f0 * tt) + 0.5 * torch.sin(4 * math.pi * f0 * tt))
    x = 0.45 * click + tone + 0.02 * torch.randn(n, generator=gen, device=device)
    pcm = torch.clamp(torch.round(x * 32767.0), -32768, 32767).to(torch.int16)
    onsets = np.arange(phase, seconds, period)
    frames = np.floor(onsets * FPS).astype(np.int64) + 1
    return pcm, frames, frames[::4]


def write_wav(path: Path, pcm: np.ndarray) -> None:
    """Write and flush to disk, so that no write-back of set-up's files runs
    inside the window."""
    with open(path, "wb") as f:
        with wave.open(f, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(np.ascontiguousarray(pcm, "<i2").tobytes())
        f.flush()
        os.fsync(f.fileno())


def read_wav(path: Path) -> np.ndarray:
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")
