"""Offline pitch shifting and time stretching (phase vocoder).

Role equivalent of the reference's pedalboard (C++/RubberBand) usage in the
offline augmentation pipeline (launch_scripts/preprocess_audio.py:332-380).
These run host-side once per corpus, never on the inference/training hot
path, so a clean numpy phase vocoder is the right tool: STFT at 2048/512,
phase accumulation along interpolated analysis frames, identity-phase
locking at unit rate, and resample-based pitch shifting.

The port's copy of beat_this_tpu/ops/stretch.py, on the port's own
`ops/resample.py`, kept so that the port imports nothing of the JAX package;
the tests hold the two to identical results.
"""

from __future__ import annotations

import numpy as np

from beat_this_tpu_torch.ops.resample import resample


def _stft(x, n_fft=2048, hop=512):
    window = np.hanning(n_fft + 1)[:-1]
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx] * window
    return np.fft.rfft(frames, axis=1).T  # (bins, frames)


def _istft(spec, n_fft=2048, hop=512):
    window = np.hanning(n_fft + 1)[:-1]
    frames = np.fft.irfft(spec.T, n=n_fft, axis=1) * window
    n_frames = frames.shape[0]
    out = np.zeros(n_fft + hop * (n_frames - 1))
    norm = np.zeros_like(out)
    wsq = window**2
    for i in range(n_frames):
        out[i * hop : i * hop + n_fft] += frames[i]
        norm[i * hop : i * hop + n_fft] += wsq
    out = out / np.maximum(norm, 1e-8)
    pad = n_fft // 2
    return out[pad:-pad]


def time_stretch(x: np.ndarray, rate: float, n_fft: int = 2048,
                 hop: int = 512) -> np.ndarray:
    """Stretch tempo by `rate` (>1 = faster/shorter) at constant pitch."""
    if rate == 1.0:
        return np.asarray(x, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    spec = _stft(x, n_fft, hop)
    n_bins, n_frames = spec.shape
    time_steps = np.arange(0, n_frames, rate)
    # expected per-hop phase advance per bin
    phi_advance = 2 * np.pi * hop * np.arange(n_bins) / n_fft
    magnitude = np.abs(spec)
    phase = np.angle(spec)
    out = np.empty((n_bins, len(time_steps)), dtype=complex)
    phase_acc = phase[:, 0].copy()
    for t, step in enumerate(time_steps):
        i0 = int(step)
        i1 = min(i0 + 1, n_frames - 1)
        frac = step - i0
        mag = (1 - frac) * magnitude[:, i0] + frac * magnitude[:, i1]
        out[:, t] = mag * np.exp(1j * phase_acc)
        # phase difference between consecutive analysis frames, unwrapped
        dphi = phase[:, i1] - phase[:, i0] - phi_advance
        dphi -= 2 * np.pi * np.round(dphi / (2 * np.pi))
        phase_acc += phi_advance + dphi
    y = _istft(out, n_fft, hop)
    target_len = int(round(len(x) / rate))
    if len(y) < target_len:
        y = np.pad(y, (0, target_len - len(y)))
    return y[:target_len]


def pitch_shift(x: np.ndarray, sr: int, semitones: float) -> np.ndarray:
    """Shift pitch by `semitones` at constant duration."""
    if semitones == 0:
        return np.asarray(x, dtype=np.float64)
    rate = 2.0 ** (-semitones / 12.0)
    stretched = time_stretch(x, rate=rate)
    # resample back to the original duration -> pitch moves by the factor
    shifted = resample(stretched, int(round(sr / rate)), sr)
    if len(shifted) < len(x):
        shifted = np.pad(shifted, (0, len(x) - len(shifted)))
    return shifted[: len(x)]
