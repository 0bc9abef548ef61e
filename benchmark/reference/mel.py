"""The log-mel spectrogram of Beat This! (beat_this/preprocessing.py:27-59):
22050 Hz, n_fft 1024, hop 441, centered frames with reflect padding,
periodic Hann window, magnitude over sqrt(n_fft), slaney mel filterbank
without norm (30-11000 Hz, 128 bins), log1p(1000 x)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SR, N_FFT, HOP, N_MELS = 22050, 1024, 441, 128
F_MIN, F_MAX = 30.0, 11000.0


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(f / 1000.0) / (np.log(6.4) / 27.0), f * 3.0 / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), m * 200.0 / 3.0)


def filterbank() -> np.ndarray:
    """(n_fft // 2 + 1, 128) triangular slaney filters, float32."""
    freqs = np.linspace(0, SR // 2, N_FFT // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(F_MIN), _hz_to_mel(F_MAX), N_MELS + 2))
    diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    down, up = -slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def dft_basis() -> np.ndarray:
    """(2 * bins, 1, n_fft) windowed cos / -sin rows."""
    n = np.arange(N_FFT)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))
    ang = 2.0 * np.pi * np.outer(np.arange(N_FFT // 2 + 1), n) / N_FFT
    return (np.concatenate([np.cos(ang), -np.sin(ang)]) * window).astype(np.float32)[:, None]


def num_frames(samples: int) -> int:
    return samples // HOP + 1


def log_mel(signal: torch.Tensor, quant=None) -> torch.Tensor:
    """(samples,) float32 or int16 PCM (over 32768) -> (frames, 128)."""
    q = quant or (lambda t: t)
    x = signal.float() / 32768.0 if signal.dtype == torch.int16 else signal.float()
    x = F.pad(x[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")
    basis = torch.from_numpy(dft_basis()).to(x.device)
    spec = F.conv1d(q(x), q(basis), stride=HOP)[0].T  # (frames, 2 bins)
    bins = N_FFT // 2 + 1
    mag = torch.sqrt(spec[:, :bins].square() + spec[:, bins:].square()) / np.sqrt(N_FFT)
    fb = torch.from_numpy(filterbank()).to(x.device)
    return torch.log1p(1000.0 * (q(mag) @ q(fb)))
