"""The PyTorch log-mel frontend against beat_this_tpu/ops/mel.py on the CPU,
float and int16 PCM input. Tolerance atol 2e-4: log1p(1000 x) magnifies the
float32 rounding of 1024-term DFT sums taken in another order by up to
1000x near silence."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beat_this_tpu.ops.mel import log_mel_spectrogram as jax_log_mel
from beat_this_tpu.ops.mel import mel_filterbank as jax_mel_filterbank
from beat_this_tpu_torch.ops.mel import log_mel_spectrogram, mel_filterbank, num_frames


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


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
