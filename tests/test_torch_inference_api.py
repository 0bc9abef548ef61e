"""The reference's public inference names in the port, each held to its JAX
counterpart on one seeded synthetic piece on the CPU: `zeropad`,
`split_piece` and `aggregate_prediction` exactly; `split_predict_aggregate`
on a small model with the JAX weights carried over (`io.checkpoint.from_jax`)
at atol 2e-3 / rtol 1e-3 (the model tolerance, tests/test_torch_inference.py);
`LogMelSpect` at atol 2e-4 (the mel tolerance, tests/test_torch_mel.py); and
the module `preprocessing` with the reference's names."""

import numpy as np
import pytest
import torch

import beat_this_tpu.inference as jax_inf
import beat_this_tpu.preprocessing as jax_pre
from beat_this_tpu.inference import LoadedModel
from beat_this_tpu.model import BeatThisConfig as JaxConfig
from beat_this_tpu.model import init_beat_this as jax_init
from beat_this_tpu_torch import inference, preprocessing
from beat_this_tpu_torch.io.audio import load_audio
from beat_this_tpu_torch.io.checkpoint import from_jax
from beat_this_tpu_torch.model import BeatThis, BeatThisConfig
from beat_this_tpu_torch.ops.mel import LogMelConfig, LogMelSpect

SMALL = dict(transformer_dim=32, n_layers=1)
CHUNK, BORDER = 200, 6


def _spect(t, seed=5):
    return np.random.default_rng(seed).standard_normal((t, 128)).astype(np.float32)


@pytest.mark.parametrize("left,right", [(0, 0), (6, 0), (0, 6), (3, 11)])
def test_zeropad(left, right):
    spect = _spect(37)
    got = inference.zeropad(spect, left, right)
    want = jax_inf.zeropad(spect, left, right)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("t", [150, 450, 1000])
@pytest.mark.parametrize("avoid_short_end", [True, False])
def test_split_piece(t, avoid_short_end):
    spect = _spect(t)
    chunks, starts = inference.split_piece(spect, CHUNK, BORDER, avoid_short_end)
    want_chunks, want_starts = jax_inf.split_piece(spect, CHUNK, BORDER, avoid_short_end)
    np.testing.assert_array_equal(starts, want_starts)
    assert len(chunks) == len(want_chunks)
    for got, want in zip(chunks, want_chunks):
        assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("overlap_mode", ["keep_first", "keep_last"])
def test_aggregate_prediction(overlap_mode):
    t = 450
    _, starts = inference.split_piece(_spect(t), CHUNK, BORDER)
    rng = np.random.default_rng(9)
    preds = [{"beat": rng.standard_normal(CHUNK).astype(np.float32),
              "downbeat": rng.standard_normal(CHUNK).astype(np.float32)} for _ in starts]
    got = inference.aggregate_prediction(preds, starts, t, CHUNK, BORDER, overlap_mode)
    want = jax_inf.aggregate_prediction(preds, starts, t, CHUNK, BORDER, overlap_mode)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # the chunks as tensors, as the port's model gives them, stitch the same
    tensors = [{k: torch.from_numpy(v) for k, v in p.items()} for p in preds]
    again = inference.aggregate_prediction(tensors, starts, t, CHUNK, BORDER, overlap_mode)
    for g, w in zip(again, want):
        assert np.array_equal(g, w)
    with pytest.raises(ValueError, match="overlap_mode"):
        inference.aggregate_prediction(preds, starts, t, CHUNK, BORDER, "average")


@pytest.mark.parametrize("overlap_mode", ["keep_first", "keep_last"])
def test_split_predict_aggregate(overlap_mode):
    params, state = jax_init(17, JaxConfig(**SMALL))
    model = BeatThis(BeatThisConfig(**SMALL))
    model.load_state_dict(from_jax(params, state))
    model.eval().requires_grad_(False)
    spect = _spect(450, seed=2)  # three chunks of 200 frames
    got = inference.split_predict_aggregate(spect, CHUNK, BORDER, overlap_mode, model,
                                            torch.float32)
    want = jax_inf.split_predict_aggregate(spect, CHUNK, BORDER, overlap_mode,
                                           LoadedModel(JaxConfig(**SMALL), params, state))
    assert set(got) == set(want) == {"beat", "downbeat"}
    for key in ("beat", "downbeat"):
        assert got[key].shape == (450,)
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("shape", [(22050,), (2, 8820)])
def test_log_mel_spect(shape):
    wave = (0.3 * np.random.default_rng(4).standard_normal(shape)).astype(np.float32)
    got = LogMelSpect(device="cpu")(wave)
    want = jax_pre.LogMelSpect()(wave)
    assert tuple(got.shape) == tuple(want.shape) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    small = dict(n_mels=64, hop_length=220, f_max=8000)
    got = LogMelSpect(device="cpu", **small)(torch.from_numpy(wave))
    want = jax_pre.LogMelSpect(**small)(wave)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    with pytest.raises(NotImplementedError):
        LogMelSpect(power=2, device="cpu")


def test_preprocessing_module():
    assert preprocessing.load_audio is load_audio
    assert preprocessing.LogMelSpect is LogMelSpect
    assert preprocessing.LogMelConfig is LogMelConfig
    assert {"load_audio", "LogMelConfig", "LogMelSpect"} <= set(vars(jax_pre))
