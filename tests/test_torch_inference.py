"""The PyTorch ChunkedPredictor against the JAX package's on the CPU: a
multi-chunk piece (small chunk_size, both overlap modes) and a piece shorter
than one chunk (the valid_lengths path). Logits are held at atol 2e-3 /
rtol 1e-3 (the model tolerance, tests/test_torch_model.py); the minimal
postprocessor's beat and downbeat times must be equal."""

import numpy as np
import pytest
import torch

from beat_this_tpu.inference import ChunkedPredictor as JaxPredictor
from beat_this_tpu.inference import LoadedModel, plan_chunks as jax_plan_chunks
from beat_this_tpu.model import BeatThisConfig as JaxConfig
from beat_this_tpu.model import init_beat_this as jax_init
from beat_this_tpu.postprocessing import Postprocessor as JaxPostprocessor
from beat_this_tpu_torch import inference
from beat_this_tpu_torch.inference import ChunkedPredictor, plan_chunks, resolve_device
from beat_this_tpu_torch.io.checkpoint import from_jax
from beat_this_tpu_torch.model import BeatThis, BeatThisConfig
from beat_this_tpu_torch.postprocessing import Postprocessor

SMALL = dict(transformer_dim=64, n_layers=1)
CHUNK, BORDER = 200, 6


@pytest.fixture(scope="module")
def models():
    params, state = jax_init(21, JaxConfig(**SMALL))
    model = BeatThis(BeatThisConfig(**SMALL))
    model.load_state_dict(from_jax(params, state))
    return LoadedModel(JaxConfig(**SMALL), params, state), model.eval().requires_grad_(False)


def _spect(t, seed):
    return np.random.default_rng(seed).standard_normal((t, 128)).astype(np.float32)


def _check(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-3, rtol=1e-3)
    beats = Postprocessor()(*got)
    jax_beats = JaxPostprocessor("minimal")(*want)
    for b, jb in zip(beats, jax_beats):
        np.testing.assert_array_equal(b, jb)


@pytest.mark.parametrize("t", [CHUNK - 2 * BORDER + 1, 450, 1000])
def test_plan_chunks(t):
    np.testing.assert_array_equal(plan_chunks(t, CHUNK, BORDER), jax_plan_chunks(t, CHUNK, BORDER))


@pytest.mark.parametrize("overlap_mode", ["keep_first", "keep_last"])
def test_multi_chunk_piece(models, overlap_mode):
    jax_model, model = models
    spect = _spect(450, 1)  # three chunks of 200 frames
    got = ChunkedPredictor(model, CHUNK, BORDER, overlap_mode=overlap_mode).predict(spect)
    want = JaxPredictor(jax_model, CHUNK, BORDER, overlap_mode=overlap_mode).predict(spect)
    _check(got, want)


def test_chunk_batches_split_the_same(models, monkeypatch):
    """Pieces with more chunks than CHUNK_BATCH run in several forwards and
    stitch to the same logits."""
    _, model = models
    spect = _spect(450, 3)
    whole = ChunkedPredictor(model, CHUNK, BORDER).predict(spect)
    monkeypatch.setattr(inference, "CHUNK_BATCH", 2)
    split = ChunkedPredictor(model, CHUNK, BORDER).predict(spect)
    for a, b in zip(whole, split):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_short_piece(models):
    jax_model, model = models
    spect = _spect(100, 2)  # 112 valid frames in a 192-frame bucket
    got = ChunkedPredictor(model, CHUNK, BORDER).predict(spect)
    want = JaxPredictor(jax_model, CHUNK, BORDER).predict(spect)
    _check(got, want)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
