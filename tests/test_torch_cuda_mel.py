"""The log-mel frontend on the card: a seeded int16 group signal packed as
directory mode packs it (`pack_flat`, four files of 100 s, so its frames
span two rFFT blocks) gives the same log-mel bit for bit with cuDNN's TF32
on and off, launches no convolution kernel, and stays within 4e-6 of the
port's CPU log-mel (the CPU's is within 5.9e-7 of a float64 DFT on this
group: both take the spectrum in float64 and round alike afterwards,
tests/test_torch_mel.py). Needs a CUDA device; skips without one. Run on
the GPU machine with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_mel.py

(the repository's conftest.py imports JAX, which that machine lacks)."""

import numpy as np
import pytest
import torch

from beat_this_tpu_torch.inference import pack_flat
from beat_this_tpu_torch.ops.mel import log_mel_spectrogram

pytestmark = pytest.mark.gpu

# kernel-name pieces of cuDNN's and the ATen convolutions
CONV_NAMES = ("conv", "fprop", "implicit_gemm", "implicit_convolve", "nchwtonhwc", "cudnn")


@pytest.fixture
def device():
    """cuda:0; restores the TF32 flags the tests set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.fixture
def group():
    rng = np.random.default_rng(2024)
    signals = [np.round(rng.uniform(-0.5, 0.5) * 32767 * np.sin(np.arange(n) * f)
                        + 300 * rng.standard_normal(n)).astype(np.int16)
               for n, f in zip([2205000, 2205123, 2204800, 2205511], [0.06, 0.11, 0.02, 0.3])]
    flat, _ = pack_flat(signals)
    assert flat.dtype == np.int16
    return torch.from_numpy(flat)


def test_log_mel_ignores_cudnn_tf32(device, group):
    x = group.to(device)
    outs = []
    for allow in (True, False):
        torch.backends.cudnn.allow_tf32 = allow
        outs.append(log_mel_spectrogram(x).cpu())
    assert torch.equal(outs[0], outs[1])


def test_log_mel_launches_no_convolution(device, group):
    from torch.profiler import ProfilerActivity, profile

    x = group.to(device)
    log_mel_spectrogram(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        log_mel_spectrogram(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    assert names, "the profiler recorded no device event"
    conv = sorted({n for n in names if any(k in n.lower() for k in CONV_NAMES)})
    assert not conv, f"convolution kernels in the log-mel: {conv}"


def test_log_mel_card_against_cpu(device, group):
    torch.backends.cuda.matmul.allow_tf32 = False
    got = log_mel_spectrogram(group.to(device)).cpu()
    want = log_mel_spectrogram(group)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=4e-6, rtol=0)
