"""Log-mel spectrogram frontend, counterpart of beat_this_tpu/ops/mel.py.

torchaudio-compatible semantics of the reference's MelSpectrogram
(beat_this/preprocessing.py:27-59): center=True with reflect padding of
n_fft // 2, periodic Hann window, onesided magnitude spectrum divided by
sqrt(n_fft) (`normalized="frame_length"`), slaney mel filterbank without
norm (f_min 30, f_max 11000, 128 mels), then `log1p(1000 * x)`. Framing,
window and real DFT run as one strided `F.conv1d` whose filters are the
windowed DFT basis.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz, min_log_mel + np.log(freq / min_log_hz) / logstep, freq / f_sp
    )


def mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), mels * f_sp
    )


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int
) -> np.ndarray:
    """Triangular slaney-scale filterbank (n_freqs, n_mels), float32, as
    torchaudio.functional.melscale_fbanks(..., norm=None, mel_scale="slaney")."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_slaney(f_min), hz_to_mel_slaney(f_max), n_mels + 2)
    f_pts = mel_to_hz_slaney(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_filters(n_fft: int) -> np.ndarray:
    """Windowed real-DFT basis as conv1d filters (2 * n_bins, 1, n_fft):
    rows k < n_bins give the real part, rows n_bins + k the imaginary part."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic Hann
    angles = 2.0 * np.pi * np.outer(np.arange(n_bins, dtype=np.float64), n) / n_fft
    basis = np.concatenate([np.cos(angles), -np.sin(angles)], axis=0)
    return (basis * window[None, :]).astype(np.float32)[:, None, :]


@dataclass(frozen=True)
class LogMelConfig:
    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 441
    f_min: float = 30.0
    f_max: float = 11000.0
    n_mels: int = 128
    log_multiplier: float = 1000.0


def num_frames(num_samples: int, hop_length: int = 441) -> int:
    return num_samples // hop_length + 1


def log_mel_spectrogram(
    waveform: torch.Tensor, config: LogMelConfig = LogMelConfig()
) -> torch.Tensor:
    """(num_samples,) or (batch, num_samples) float waveform, or int16 PCM
    (scaled by 1/32768), -> (frames, n_mels) or (batch, frames, n_mels)
    float32 log-mel values on the waveform's device, with
    frames = num_samples // hop_length + 1."""
    c = config
    squeeze = waveform.ndim == 1
    x = waveform[None] if squeeze else waveform
    if x.dtype == torch.int16:
        x = x.float() * (1.0 / 32768.0)
    else:
        x = x.float()
    pad = c.n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")
    filters = torch.from_numpy(_dft_filters(c.n_fft)).to(x.device)
    spec = F.conv1d(x, filters, stride=c.hop_length).transpose(1, 2)  # (B, frames, 2 n_bins)
    n_bins = c.n_fft // 2 + 1
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    mag = torch.sqrt(re * re + im * im) * (1.0 / np.sqrt(c.n_fft))
    fb = torch.from_numpy(
        mel_filterbank(n_bins, c.f_min, c.f_max, c.n_mels, c.sample_rate)
    ).to(x.device)
    out = torch.log1p(c.log_multiplier * (mag @ fb))
    return out[0] if squeeze else out


class LogMelSpect:
    """Callable-class surface of `log_mel_spectrogram`, as the reference's
    `beat_this.preprocessing.LogMelSpect` module (beat_this/preprocessing.py:
    26-63) and beat_this_tpu/ops/mel.py:LogMelSpect: construct with the
    spectrogram's parameters, call with a (num_samples,) or (batch,
    num_samples) waveform (tensor or array), get (frames, n_mels) log-mel
    values on `device` (CUDA unless the caller asks for the CPU).
    `mel_scale`, `normalized` and `power` take only the reference's
    defaults, the only values the model was trained with."""

    def __init__(self, sample_rate=22050, n_fft=1024, hop_length=441, f_min=30, f_max=11000,
                 n_mels=128, mel_scale="slaney", normalized="frame_length", power=1,
                 log_multiplier=1000, device="cuda"):
        if (mel_scale, normalized, power) != ("slaney", "frame_length", 1):
            raise NotImplementedError(
                "only the reference configuration is implemented: "
                "mel_scale='slaney', normalized='frame_length', power=1"
            )
        self.device = torch.device(device)
        self.config = LogMelConfig(
            sample_rate=sample_rate, n_fft=n_fft, hop_length=hop_length, f_min=float(f_min),
            f_max=float(f_max), n_mels=n_mels, log_multiplier=float(log_multiplier),
        )

    def __call__(self, waveform) -> torch.Tensor:
        return log_mel_spectrogram(torch.as_tensor(waveform, device=self.device), self.config)
