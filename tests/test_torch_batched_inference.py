"""Batched inference of the port on the CPU, float32. `predict_many` over
pieces of 40, 601, 1500 and 3100 frames against `predict` one piece at a
time: bit for bit where both run the same forwards (one chunk per forward,
torch on one thread), which holds everything `predict_many` does itself
(chunk plans, packing, stitching, the short pieces' buckets); within 1e-6
where forwards are shared between pieces or torch runs on several threads.
The libraries under torch are not invariant to the batch: they choose
kernels by the batch size, and the elementwise CPU kernels (sigmoid, exp,
erf) split a tensor across threads and compute each thread's unaligned tail
in scalar code, one ulp off the vector code (3 of 96000 sigmoids differ when
240000 are computed together). Against the JAX package's `predict_many`:
atol 2e-3 / rtol 1e-3 (the model tolerance at small geometry). `BatchedFile2File` over a
directory writes the bytes `File2File` writes per file, with both
postprocessors, and `predict_postprocess_batched` yields the per-piece
results. The hub module exports the names of the repository's hubconf.py."""

import numpy as np
import pytest
import torch

from beat_this_tpu.inference import ChunkedPredictor as JaxPredictor
from beat_this_tpu.inference import LoadedModel
from beat_this_tpu.io.audio import save_wav
from beat_this_tpu.model import BeatThisConfig as JaxConfig
from beat_this_tpu.model import init_beat_this as jax_init
from beat_this_tpu_torch import inference
from beat_this_tpu_torch.inference import (
    BatchedFile2File,
    ChunkedPredictor,
    File2File,
    predict_postprocess_batched,
)
from beat_this_tpu_torch.io.checkpoint import from_jax
from beat_this_tpu_torch.model import BeatThis, BeatThisConfig
from beat_this_tpu_torch.postprocessing import Postprocessor

# no partial transformers: the frontend's blocks are most of a small model's forward and
# have no part in how pieces are packed and stitched
SMALL = dict(transformer_dim=64, n_layers=1, partial_transformers=False)
LENGTHS = (40, 601, 1500, 3100)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The DBN's per-frame loop is thousands of tiny operations per piece:
    threads add only their hand-off, which costs minutes where several test
    processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    params, state = jax_init(33, JaxConfig(**SMALL))
    model = BeatThis(BeatThisConfig(**SMALL))
    state_dict = from_jax(params, state)
    model.load_state_dict(state_dict)
    return (LoadedModel(JaxConfig(**SMALL), params, state),
            model.eval().requires_grad_(False), state_dict)


@pytest.fixture(scope="module")
def spects():
    return [np.random.default_rng(t).standard_normal((t, 128)).astype(np.float32)
            for t in LENGTHS]


def _predict(model, spects, chunk_batch, threads, singles=False):
    """predict_many (or predict piece by piece) with `chunk_batch` chunks per
    forward on `threads` torch threads."""
    before = torch.get_num_threads(), inference.CHUNK_BATCH
    torch.set_num_threads(threads)
    inference.CHUNK_BATCH = chunk_batch
    try:
        predictor = ChunkedPredictor(model)
        return [predictor.predict(s) for s in spects] if singles else predictor.predict_many(spects)
    finally:
        torch.set_num_threads(before[0])
        inference.CHUNK_BATCH = before[1]


@pytest.fixture(scope="module")
def exact(models, spects):
    """(predict_many, predict per piece), one chunk per forward, one thread."""
    return _predict(models[1], spects, 1, 1), _predict(models[1], spects, 1, 1, singles=True)


@pytest.fixture(scope="module")
def many(models, spects):
    return ChunkedPredictor(models[1]).predict_many(spects)


@pytest.mark.parametrize("index", range(len(LENGTHS)))
def test_predict_many_equals_predict_bit_for_bit(exact, index):
    for g, w in zip(exact[0][index], exact[1][index]):
        assert g.shape == (LENGTHS[index],) and g.dtype == np.float32
        assert np.array_equal(g, w)


@pytest.mark.parametrize("chunk_batch,threads", [(3, 1), (16, 4)])
def test_predict_many_with_shared_forwards_stays_within_rounding(models, spects, exact,
                                                                 chunk_batch, threads):
    got = _predict(models[1], spects, chunk_batch, threads)
    for (gb, gd), (wb, wd) in zip(got, exact[1]):
        np.testing.assert_allclose(gb, wb, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(gd, wd, atol=1e-6, rtol=1e-6)


def test_predict_many_agrees_with_the_jax_package(models, spects, many):
    want = JaxPredictor(models[0]).predict_many(spects)
    for (gb, gd), (wb, wd) in zip(many, want):
        np.testing.assert_allclose(gb, np.asarray(wb), atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(gd, np.asarray(wd), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("kind", ["minimal", "dbn"])
def test_predict_postprocess_batched_equals_per_piece(models, spects, kind):
    predictor, post = ChunkedPredictor(models[1]), Postprocessor(kind)
    pieces = [{"spect": s, "name": i} for i, s in enumerate(spects[:3])]
    got = list(predict_postprocess_batched(predictor, post, pieces, group_size=2))
    assert [p["name"] for p, _, _ in got] == [0, 1, 2]
    for piece, beats, downbeats in got:
        want = post(*predictor.predict(piece["spect"]))
        assert np.array_equal(beats, want[0]) and np.array_equal(downbeats, want[1])


@pytest.fixture(scope="module")
def audio_dir(models, tmp_path_factory):
    root = tmp_path_factory.mktemp("batched")
    torch.save({"state_dict": {"model." + k: v for k, v in models[2].items()},
                "hyper_parameters": SMALL}, root / "tiny.ckpt")
    rng = np.random.default_rng(1)
    (root / "in").mkdir()
    for name, seconds, rate in (("a", 0.9, 22050), ("b", 31.0, 22050), ("c", 12.5, 44100),
                                ("d", 4.0, 22050)):
        t = np.arange(int(rate * seconds)) / rate
        clicks = (np.sin(2 * np.pi * 2 * t) > 0.95) * np.sin(2 * np.pi * 1000 * t)
        save_wav(root / "in" / f"{name}.wav",
                 0.3 * clicks + 0.02 * rng.standard_normal(len(t)), rate)
    return root


@pytest.mark.parametrize("dbn", [False, True])
def test_batched_file2file_writes_file2file_bytes(audio_dir, dbn):
    ckpt = audio_dir / "tiny.ckpt"
    batched = BatchedFile2File(ckpt, "cpu", dbn=dbn, group_size=3)
    single = File2File(ckpt, "cpu", dbn=dbn)
    names = ("a", "b", "c", "d")
    out = audio_dir / f"out-{dbn}"
    seen = []
    seconds = batched.process_many(
        [(audio_dir / "in" / f"{n}.wav", out / f"{n}.beats") for n in names],
        after_each=lambda path, beats_path, beat, down: seen.append((path.stem, len(beat))))
    assert [n for n, _ in seen] == list(names) and seconds == pytest.approx(48.4, abs=0.01)
    for n in names:
        single(audio_dir / "in" / f"{n}.wav", out / f"{n}.single")
        got = (out / f"{n}.beats").read_bytes()
        assert got == (out / f"{n}.single").read_bytes()
    assert (out / "b.beats").read_bytes()


def test_batched_file2file_reports_a_failing_file(audio_dir):
    batched = BatchedFile2File(audio_dir / "tiny.ckpt", "cpu", group_size=2)
    errors = []
    out = audio_dir / "out-errors"
    batched.process_many([(audio_dir / "in" / "missing.wav", out / "missing.beats"),
                          (audio_dir / "in" / "d.wav", out / "d.beats")],
                         on_error=lambda path, exc: errors.append((path.name, type(exc))))
    assert [name for name, _ in errors] == ["missing.wav"]


@pytest.mark.parametrize("dbn", [False, True])
def test_batched_file2file_survives_a_failing_forward(audio_dir, monkeypatch, dbn):
    """A file that loads but fails in the forward is reported; the others
    of its group are written, with the bytes the per-file path writes."""
    batched = BatchedFile2File(audio_dir / "tiny.ckpt", "cpu", dbn=dbn, group_size=3)
    predict_many = batched.predictor.predict_many
    predict_many_device = batched.predictor.predict_many_device

    def failing(spects):  # a.wav is the only piece under 100 frames
        if any(len(s) < 100 for s in spects):
            raise RuntimeError("forward failed")
        return predict_many(spects)

    def failing_device(mel, offsets, nframes):  # the group's own path, as `failing`
        if min(nframes) < 100:
            raise RuntimeError("forward failed")
        return predict_many_device(mel, offsets, nframes)

    monkeypatch.setattr(batched.predictor, "predict_many", failing)
    monkeypatch.setattr(batched.predictor, "predict_many_device", failing_device)
    errors, seen = [], []
    out = audio_dir / f"out-forward-{dbn}"
    batched.process_many([(audio_dir / "in" / f"{n}.wav", out / f"{n}.beats") for n in "dac"],
                         on_error=lambda path, exc: errors.append((path.name, str(exc))),
                         after_each=lambda path, *rest: seen.append(path.name))
    assert errors == [("a.wav", "forward failed")] and seen == ["d.wav", "c.wav"]
    assert not (out / "a.beats").exists()
    single = File2File(audio_dir / "tiny.ckpt", "cpu", dbn=dbn)
    for n in "dc":
        single(audio_dir / "in" / f"{n}.wav", out / f"{n}.single")
        assert (out / f"{n}.beats").read_bytes() == (out / f"{n}.single").read_bytes()
    assert (out / "d.beats").exists() and not (out / "missing.beats").exists()


def test_hub_exports_the_hubconf_names(audio_dir):
    import hubconf
    from beat_this_tpu_torch import hub

    names = [n for n in vars(hubconf) if not n.startswith("_") and n != "dependencies"]
    assert sorted(names) == sorted(["beat_this", "BeatThis", "Spect2Frames", "Audio2Frames",
                                    "Audio2Beats", "File2Beats", "File2File"])
    for name in names:
        assert hasattr(hub, name), name
    assert hub.dependencies == ["torch", "numpy"]
    assert hub.beat_this is inference.load_model and hub.BeatThis is BeatThis
    model = hub.beat_this(audio_dir / "tiny.ckpt", "cpu")
    assert isinstance(model, BeatThis) and not model.training
    beats, downbeats = hub.File2Beats(audio_dir / "tiny.ckpt", "cpu")(audio_dir / "in" / "d.wav")
    assert beats.ndim == 1 and downbeats.ndim == 1
