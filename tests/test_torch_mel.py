"""The PyTorch log-mel frontend against beat_this_tpu/ops/mel.py on the CPU,
float and int16 PCM input. Tolerance atol 2e-4: log1p(1000 x) magnifies the
float32 rounding of 1024-term DFT sums taken in another order by up to
1000x near silence.

The blocked rFFT is also held to a float64 numpy direct DFT of the same
semantics at `F64_ATOL`, over signals whose frames span several blocks
(the block size cut small, and at its real size around a block boundary),
a batch and the shortest signal the reflect padding takes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beat_this_tpu.ops.mel import log_mel_spectrogram as jax_log_mel
from beat_this_tpu.ops.mel import mel_filterbank as jax_mel_filterbank
from beat_this_tpu_torch.ops import mel as mel_ops
from beat_this_tpu_torch.ops.mel import log_mel_spectrogram, mel_filterbank, num_frames

N_FFT, HOP = 1024, 441

# Against the float64 DFT: the spectrum is taken in float64, so what is
# left is the float32 rounding of the magnitudes, the filterbank sums and
# log1p, a few units in the last place of values up to 8 (4.8e-7): these
# signals miss by at most 5.2e-7, tests/test_torch_cuda_mel.py's group by
# 5.9e-7. A float32 rFFT misses by 1e-6 to 5.4e-6 here (2.4e-5 on that
# group's loud tones over a quiet floor), TF32 products by 3e-3 and more,
# bfloat16 products by 2.5e-2 and more:
# `test_float64_tolerance_rejects_bf16_products` holds the last.
F64_ATOL = 2e-6


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _dft_log_mel(x, frames=None, operands=lambda a: a):
    """Float64 log-mel of a (num_samples,) signal by a direct DFT: reflect
    padding of n_fft // 2, periodic Hann window, magnitude over sqrt(n_fft),
    the port's filterbank, log1p(1000 x). `frames` picks frame indices;
    `operands` rounds the windowed frames and the DFT basis."""
    x = np.asarray(x, np.float64)
    padded = np.pad(x, (N_FFT // 2, N_FFT // 2), mode="reflect")
    if frames is None:
        frames = np.arange(num_frames(len(x)))
    n = np.arange(N_FFT)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))
    windowed = operands(padded[frames[:, None] * HOP + n[None, :]] * window)
    angles = 2.0 * np.pi * np.outer(n, np.arange(N_FFT // 2 + 1)) / N_FFT
    re = windowed @ operands(np.cos(angles))
    im = windowed @ operands(-np.sin(angles))
    mag = np.sqrt(re * re + im * im) / np.sqrt(N_FFT)
    fb = mel_filterbank(N_FFT // 2 + 1, 30.0, 11000.0, 128, 22050).astype(np.float64)
    return np.log1p(1000.0 * (mag @ fb))


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).double().numpy()


def test_filterbank_equal():
    np.testing.assert_array_equal(
        mel_filterbank(513, 30.0, 11000.0, 128, 22050),
        jax_mel_filterbank(513, 30.0, 11000.0, 128, 22050),
    )


@pytest.mark.parametrize("n", [22050, 22050 + 123])
def test_float_input(n):
    x = _signal(n)
    got = log_mel_spectrogram(torch.from_numpy(x))
    want = np.asarray(jax_log_mel(jnp.asarray(x)))
    assert got.shape == want.shape == (num_frames(n), 128)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_int16_input_and_batch():
    pcm = np.round(_signal(30000, 1) * 32767).astype(np.int16)
    batch = np.stack([pcm, pcm[::-1].copy()])
    got = log_mel_spectrogram(torch.from_numpy(batch))
    want = np.asarray(jax_log_mel(jnp.asarray(batch)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    # int16 equals the float path at the exact PCM scale
    as_float = log_mel_spectrogram(torch.from_numpy(pcm.astype(np.float32) / 32768.0))
    torch.testing.assert_close(log_mel_spectrogram(torch.from_numpy(pcm)), as_float, atol=0, rtol=0)


# (samples, batch rows or None for a 1-D signal, frames a block or None for
# the module's own): 25 frames in blocks of 8 end one frame into the fourth;
# 3 rows of 25 in blocks of 2 frames a row (8 // 3) end one frame into the
# 13th; 3 rows over a block of 2 frames run one frame a block; 513 samples
# (two frames) is the shortest signal the reflect padding of 512 takes.
CASES = {
    "blocks_end_mid_block": (24 * HOP + 300, None, 8),
    "batch_in_blocks": (24 * HOP + 300, 3, 8),
    "batch_wider_than_block": (24 * HOP + 300, 3, 2),
    "batch_one_block": (30000, 2, None),
    "shortest": (N_FFT // 2 + 1, None, None),
}


@pytest.fixture(params=list(CASES), ids=list(CASES))
def case(request, monkeypatch):
    n, rows, block = CASES[request.param]
    if block is not None:
        monkeypatch.setattr(mel_ops, "_BLOCK_FRAMES", block)
    signals = [_signal(n, seed) for seed in range(rows or 1)]
    return (signals[0] if rows is None else np.stack(signals)), num_frames(n)


def test_cases_against_jax(case):
    x, frames = case
    got = log_mel_spectrogram(torch.from_numpy(x))
    want = np.asarray(jax_log_mel(jnp.asarray(x)))
    assert got.shape == want.shape == x.shape[:-1] + (frames, 128)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_cases_against_float64_dft(case):
    x, frames = case
    got = log_mel_spectrogram(torch.from_numpy(x)).numpy().reshape(-1, frames, 128)
    for row, signal in zip(got, x.reshape(-1, x.shape[-1])):
        np.testing.assert_allclose(row, _dft_log_mel(signal), atol=F64_ATOL, rtol=0)


def test_cases_int16_equals_float_path(case):
    x, _ = case
    pcm = np.round(x * 32767).astype(np.int16)
    as_float = log_mel_spectrogram(torch.from_numpy(pcm.astype(np.float32) / 32768.0))
    torch.testing.assert_close(log_mel_spectrogram(torch.from_numpy(pcm)), as_float, atol=0, rtol=0)


def test_float64_tolerance_rejects_bf16_products():
    x = _signal(22050 + 123)
    exact = _dft_log_mel(x)
    assert np.abs(_dft_log_mel(x, operands=_bf16) - exact).max() > 100 * F64_ATOL


def test_real_block_boundary_against_float64_dft():
    """A signal one block and 37 frames long at the module's block size: the
    frames on both sides of the boundary and the last ones, against the
    float64 DFT."""
    frames = mel_ops._BLOCK_FRAMES + 37
    x = _signal((frames - 1) * HOP + 200, seed=5)
    got = log_mel_spectrogram(torch.from_numpy(x)).numpy()
    assert got.shape == (frames, 128)
    pick = np.r_[0, mel_ops._BLOCK_FRAMES - 3 : mel_ops._BLOCK_FRAMES + 3, frames - 3 : frames]
    np.testing.assert_allclose(got[pick], _dft_log_mel(x, pick), atol=F64_ATOL, rtol=0)
