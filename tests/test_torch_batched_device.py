"""Directory mode's device-resident group path of the port on the CPU,
float32, against the port's per-file path and the JAX package's group path:

* the packed-flat group log-mel (`_batched_spects`) equals the port's
  per-file log-mel (`signal2spect`) within 1e-6 relative, and bit for bit
  on one torch thread for signals of 50 frames and more (hop multiples and
  one off, 70007 samples). torch's CPU convolution takes another algorithm
  for an output of one or two frames (300 and 600 samples, around the
  512-sample reflect window; 8.4e-7 apart at most), and splits a long one
  across threads (7e-8 apart). It is
  within the log-mel tolerance of `tests/test_torch_mel.py` (atol 2e-4) of
  the JAX package's `_batched_spects` on the same signals;
* with an empty file in any slot, the group's log-mel is still the JAX
  package's, and the group stays on the device path;
* `_as_pcm16_if_exact` decides as the JAX package's on the edge cases of
  `tests/test_batched_inference.py`; `_load_one` gives a 16-bit mono wav
  at 22050 Hz as its int16 samples (other audio as float32, int16 where
  exact), the JAX package's signal once scaled; the int16 upload of
  `pack_flat` gives the float upload's log-mel bit for bit;
* `predict_many_device` on the device-resident log-mel gives `predict_many`'s
  logits on the downloaded slices bit for bit (chunk 96, border 6; lengths
  that straddle the short / long boundary at one stride);
* a failure of the device path is printed on stderr, counted, and the
  group's logits come from the host path unchanged;
* `BatchedFile2File` writes `File2File`'s bytes with every group on the
  device path.
"""

import numpy as np
import pytest
import torch

import beat_this_tpu.inference as jax_inference
from beat_this_tpu_torch import inference
from beat_this_tpu_torch.inference import (
    BatchedFile2File,
    ChunkedPredictor,
    File2File,
    pack_flat,
    pcm16_to_float,
)
from beat_this_tpu_torch.io.audio import load_audio, save_wav
from beat_this_tpu_torch.io.checkpoint import init_beat_this
from beat_this_tpu_torch.model import BeatThis, BeatThisConfig
from beat_this_tpu_torch.ops.mel import num_frames

SMALL = dict(transformer_dim=64, n_layers=1, partial_transformers=False)
MEL_LENGTHS = (300, 600, 441 * 50 - 1, 441 * 50, 441 * 50 + 1, 22050, 70007)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test processes share the cores: torch's thread hand-off then
    costs more than its threads gain."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bare():
    """A BatchedFile2File with no model: the log-mel runs on the CPU."""
    f2f = BatchedFile2File.__new__(BatchedFile2File)
    f2f.device = torch.device("cpu")
    return f2f


@pytest.fixture(scope="module")
def model():
    config = BeatThisConfig(**SMALL)
    net = BeatThis(config)
    net.load_state_dict(init_beat_this(5, config))
    return net.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def signals():
    rng = np.random.RandomState(7)
    return [0.3 * rng.randn(n).astype(np.float32) for n in MEL_LENGTHS]


@pytest.mark.parametrize("threads", [1, 4])
def test_flat_mel_equals_the_per_file_mel(signals, threads):
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        f2f = _bare()
        got = f2f._batched_spects(signals)
        wants = [f2f.signal2spect(s, 22050) for s in signals]
    finally:
        torch.set_num_threads(before)
    for s, g, want in zip(signals, got, wants):
        assert g.shape == want.shape == (num_frames(len(s)), 128)
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=0)
        if threads == 1 and len(g) >= 50:
            np.testing.assert_array_equal(g, want)


def test_flat_mel_agrees_with_the_jax_package(signals):
    got = _bare()._batched_spects(signals)
    want = jax_inference.BatchedFile2File.__new__(jax_inference.BatchedFile2File)
    for g, w in zip(got, want._batched_spects(signals)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4, rtol=0)


def test_pcm16_decision_matches_the_jax_package():
    rng = np.random.RandomState(21)
    cases = [
        rng.randint(-32768, 32768, 22050).astype(np.float32) / 32768.0,  # a 16-bit decode
        0.3 * rng.randn(5000).astype(np.float32),  # resampled or float audio
        np.full(16, 32767.0 / 32768.0, np.float32),  # the largest PCM value
        np.full(16, 1.0001, np.float32),  # over full scale
        np.full(16, -1.0, np.float32),  # -32768 rounds below the int16 range's top
        np.zeros(0, np.float32),
    ]
    odd = cases[0].copy()
    odd[1] += np.float32(0.25 / 32768.0)  # a sample the strided first look skips
    cases.append(odd)
    for x in cases:
        got, want = inference._as_pcm16_if_exact(x), jax_inference._as_pcm16_if_exact(x)
        assert got.dtype == want.dtype
        assert (got is x) == (want is x)
        np.testing.assert_array_equal(got, want)


def test_pcm16_upload_gives_the_float_upload_mel():
    rng = np.random.RandomState(3)
    pcm = [rng.randint(-32768, 32768, n).astype(np.int16) for n in (400, 22050, 441 * 30 + 7)]
    floats = [pcm16_to_float(x) for x in pcm]
    assert pack_flat(pcm)[0].dtype == np.int16 and pack_flat(floats)[0].dtype == np.float32
    assert pack_flat(pcm[:1] + floats[1:])[0].dtype == np.float32  # a mixed group
    f2f = _bare()
    want = f2f._batched_spects(floats)
    for group in (pcm, pcm[:1] + floats[1:]):
        for g, w in zip(f2f._batched_spects(group), want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("empty_at", [0, 1, 2])
def test_empty_file_in_a_group(model, signals, empty_at, capsys):
    group = [signals[1], signals[5]]
    group.insert(empty_at, np.zeros(0, np.float32))
    f2f = _bare()
    got = f2f._batched_spects(group)
    want = jax_inference.BatchedFile2File.__new__(jax_inference.BatchedFile2File)
    for g, w in zip(got, want._batched_spects(group)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4, rtol=0)
    f2f.predictor = ChunkedPredictor(model, chunk_size=96, border_size=6)
    before = BatchedFile2File.host_groups
    logits = f2f._group_logits(group)
    assert "falling back" not in capsys.readouterr().err
    assert BatchedFile2File.host_groups == before
    assert [len(b) for b, _ in logits] == [num_frames(len(x)) for x in group]


def test_load_one_keeps_16_bit_pcm(tmp_path):
    rng = np.random.RandomState(9)
    x = 0.1 * rng.randn(5000)  # no sample clipped to -32768, which int16 upload declines
    save_wav(tmp_path / "mono.wav", x, 22050)
    save_wav(tmp_path / "dual.wav", np.stack([x, x], 1), 22050)  # equal channels: exact
    save_wav(tmp_path / "stereo.wav", np.stack([x, -0.5 * x], 1), 22050)
    save_wav(tmp_path / "float.wav", x, 22050, bits_per_sample=32)
    save_wav(tmp_path / "rate.wav", x, 44100)
    jax_f2f = jax_inference.BatchedFile2File.__new__(jax_inference.BatchedFile2File)
    for name, dtype in (("mono", np.int16), ("dual", np.int16), ("stereo", np.float32),
                        ("float", np.float32), ("rate", np.float32)):
        signal, seconds = BatchedFile2File._load_one(tmp_path / f"{name}.wav")
        assert signal.dtype == dtype, name
        assert seconds == 5000 / (44100 if name == "rate" else 22050)
        want = jax_f2f._load_one(tmp_path / f"{name}.wav")
        if name == "rate":  # the port's resampler is held to the JAX package's elsewhere
            np.testing.assert_allclose(pcm16_to_float(signal), want, atol=1e-6)
        else:
            np.testing.assert_array_equal(pcm16_to_float(signal), want)
    mono = BatchedFile2File._load_one(tmp_path / "mono.wav")[0]
    np.testing.assert_array_equal(mono, load_audio(tmp_path / "mono.wav")[0] * 32768.0)


def _device_and_host(model, lengths, seed):
    predictor = ChunkedPredictor(model, chunk_size=96, border_size=6)
    f2f = _bare()
    f2f.predictor = predictor
    rng = np.random.RandomState(seed)
    sigs = [0.3 * rng.randn(n).astype(np.float32) for n in lengths]
    got = predictor.predict_many_device(*f2f._batched_spects_device(sigs))
    return f2f, sigs, got, predictor.predict_many(f2f._batched_spects(sigs))


def test_predict_many_device_equals_predict_many(model):
    stride = 96 - 2 * 6
    lengths = (300, 3000, 441 * stride - 441, 441 * stride, 441 * stride + 441, 441 * 200)
    assert [num_frames(n) for n in lengths] == [1, 7, stride, stride + 1, stride + 2, 201]
    _, _, got, want = _device_and_host(model, lengths, 11)
    assert len(got) == len(want)
    for (gb, gd), (wb, wd), n in zip(got, want, lengths):
        assert gb.shape == (num_frames(n),)
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gd, wd)


def test_device_path_failure_is_printed_and_falls_back(model, capsys, monkeypatch):
    f2f, sigs, _, want = _device_and_host(model, (22050, 60000), 3)
    before = BatchedFile2File.host_groups
    first = f2f._group_logits(sigs)
    assert "falling back" not in capsys.readouterr().err
    assert BatchedFile2File.host_groups == before

    device_path = f2f.predictor.predict_many_device
    calls = []

    def fails_once(*args):  # the device path's call; the host path's runs
        calls.append(args)
        if len(calls) == 1:
            raise RuntimeError("synthetic device-path failure")
        return device_path(*args)

    monkeypatch.setattr(f2f.predictor, "predict_many_device", fails_once)
    second = f2f._group_logits(sigs)
    err = capsys.readouterr().err
    assert "device-resident group inference failed with RuntimeError" in err
    assert "synthetic device-path failure" in err
    assert BatchedFile2File.host_groups == before + 1
    assert len(calls) == 2 and calls[1][1] == [0, len(want[0][0])]  # the downloaded slices
    for res in (first, second):
        for (gb, gd), (wb, wd) in zip(res, want):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gd, wd)


def test_batched_file2file_writes_file2file_bytes_on_the_device_path(model, tmp_path):
    torch.save({"state_dict": {"model." + k: v for k, v in model.state_dict().items()},
                "hyper_parameters": SMALL}, tmp_path / "tiny.ckpt")
    rng = np.random.default_rng(4)
    names = ("a", "b", "c")
    for name, seconds in zip(names, (0.7, 21.0, 6.3)):
        t = np.arange(int(22050 * seconds)) / 22050
        clicks = (np.sin(2 * np.pi * 2 * t) > 0.95) * np.sin(2 * np.pi * 1000 * t)
        save_wav(tmp_path / f"{name}.wav", 0.3 * clicks + 0.02 * rng.standard_normal(len(t)),
                 22050)
    before = BatchedFile2File.host_groups
    batched = BatchedFile2File(tmp_path / "tiny.ckpt", "cpu", group_size=3)
    batched.process_many([(tmp_path / f"{n}.wav", tmp_path / f"{n}.beats") for n in names])
    assert BatchedFile2File.host_groups == before
    single = File2File(tmp_path / "tiny.ckpt", "cpu")
    for n in names:
        single(tmp_path / f"{n}.wav", tmp_path / f"{n}.single")
        assert (tmp_path / f"{n}.beats").read_bytes() == (tmp_path / f"{n}.single").read_bytes()
