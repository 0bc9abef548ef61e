"""The port's launch-script drivers against the JAX package's scripts on the
CPU, on one synthetic corpus and checkpoint (the fixtures of
tests/test_drivers.py): `preprocess_audio` writes the same files (wavs
byte-identical, spectrograms within float16 rounding), `compute_paper_metrics`
gives the same per-piece metrics in all three aggregation modes and rejects
repeated pieces, `clean_checkpoints` cleans checkpoints of both packages'
trainers into files both packages load, and `compare_activations` (numpy
only, used as it is) passes the two CLIs' `--activations` dumps at the
float32 parity tolerance and fails a perturbed one. Also the profiler's
`Throughput`, `maybe_trace` and the CLI's summary line."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# first: importing tests.test_drivers puts launch_scripts/ on the path
from tests.test_drivers import LAUNCH, _make_ckpt, raw_corpus  # noqa: F401, I001
import clean_checkpoints as jax_clean
import compute_paper_metrics as jax_cpm
import preprocess_audio as jax_pa
from beat_this_tpu.cli import run as jax_cli
from beat_this_tpu.io.torch_ckpt import load_torch_checkpoint, torch_state_dict_to_pytree
from beat_this_tpu.io.torch_save import save_torch_checkpoint
from beat_this_tpu.model import BeatThisConfig as JaxConfig
from beat_this_tpu_torch import clean_checkpoints, compute_paper_metrics, preprocess_audio
from beat_this_tpu_torch import cli, profiler
from beat_this_tpu_torch.inference import load_model
from beat_this_tpu_torch.io.checkpoint import load_checkpoint, to_jax
from tests.test_dataset import AUGS, make_corpus

# the float32 logit parity tolerance at small geometry (tests/test_parity_torch.py:55)
F32_ATOL = 2e-3
PITCH, TEMPO = (-1, 1), (4, 4)


def _f16_close(got: np.ndarray, want: np.ndarray) -> bool:
    """Equal within float16 rounding: at most one float16 step apart."""
    got32, want32 = got.astype(np.float32), want.astype(np.float32)
    step = np.spacing(np.maximum(np.abs(got32), np.abs(want32)).astype(np.float16))
    return got.shape == want.shape and bool(np.all(np.abs(got32 - want32) <= step))


def test_preprocess_matches_the_jax_script(raw_corpus, tmp_path, monkeypatch):  # noqa: F811
    """Both scripts' three stages over one raw corpus, each in its own tree."""
    port_root = tmp_path / "port"
    shutil.copytree(raw_corpus / "data" / "annotations", port_root / "data" / "annotations")
    roots = {"jax": raw_corpus, "port": port_root}
    for name, mod in (("jax", jax_pa), ("port", preprocess_audio)):
        monkeypatch.setattr(mod, "BASEPATH", roots[name])
        mod.AudioPreprocessing(raw_corpus / "data" / "audio_paths.tsv", pitch_shift=PITCH,
                               time_stretch=TEMPO).preprocess_audio()
        kwargs = {"device": "cpu"} if mod is preprocess_audio else {}
        mod.SpectCreation(PITCH, TEMPO, **kwargs).create_spects()
        mod.create_npz(roots[name] / "data" / "audio" / "spectrograms")
    trees = {name: root / "data" / "audio" for name, root in roots.items()}
    files = {name: sorted(p.relative_to(t) for p in t.rglob("*") if p.is_file())
             for name, t in trees.items()}
    assert files["port"] == files["jax"]
    suffixes = {p.suffix for p in files["port"]}
    assert suffixes == {".wav", ".npy", ".npz"}
    assert len([p for p in files["port"] if p.suffix == ".wav"]) == 2 * 5  # track + 4 variants
    for rel in files["port"]:
        got, want = trees["port"] / rel, trees["jax"] / rel
        if rel.suffix == ".wav":
            assert got.read_bytes() == want.read_bytes(), rel
        elif rel.suffix == ".npy":
            a, b = np.load(got), np.load(want)
            assert a.dtype == b.dtype == np.float16 and _f16_close(a, b), rel
        else:
            a, b = np.load(got), np.load(want)
            assert sorted(a.files) == sorted(b.files) and "song0/track_ts4" in a.files
            for key in a.files:
                assert _f16_close(a[key], b[key]), (rel, key)


def _recorded(monkeypatch, mod) -> list:
    """Every return of `mod.compute_predictions` from here on, in order."""
    calls, orig = [], mod.compute_predictions

    def record(*args, **kwargs):
        calls.append(orig(*args, **kwargs))
        return calls[-1]

    monkeypatch.setattr(mod, "compute_predictions", record)
    return calls


def _run_both(monkeypatch, capsys, argv: list, dump=None) -> tuple:
    """Both drivers' `main` on `argv` (the port's on the CPU): per driver
    its per-piece results, one tuple (metrics, datasets, predictions,
    pieces) per model, and the tables it printed after its last model."""
    results = {}
    for name, mod, extra in (("jax", jax_cpm, []), ("port", compute_paper_metrics,
                                                     ["--device", "cpu"])):
        calls = _recorded(monkeypatch, mod)
        own = [] if dump is None else ["--dump-predictions", str(dump.with_suffix(f".{name}.npz"))]
        capsys.readouterr()
        mod.main(mod.get_parser().parse_args(argv + own + extra))
        out = capsys.readouterr().out
        results[name] = (calls, out[out.rindex("Computing predictions ...\n"):])
    return results["jax"], results["port"]


def _assert_same_pieces(jax_run, port_run):
    """The same pieces with the same beats and metrics, the same tables."""
    (jax_calls, jax_out), (port_calls, port_out) = jax_run, port_run
    assert port_out == jax_out
    assert len(port_calls) == len(jax_calls) > 0
    for (jm, jd, jp, jn), (pm, pd, pp, pn) in zip(jax_calls, port_calls):
        assert list(pn) == list(jn) and list(pd) == list(jd)
        assert sorted(pm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], rtol=0, atol=1e-9, err_msg=k)
        for (pb, pdb), (jb, jdb) in zip(pp, jp):
            assert np.array_equal(pb, jb) and np.array_equal(pdb, jdb)


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    """A 4-piece corpus in two folds and one checkpoint per fold."""
    root = tmp_path_factory.mktemp("folds")
    data = root / "data"
    data.mkdir()
    make_corpus(data, n_pieces=4, frames=280, dataset="alpha", augmentations=AUGS,
                split="folds")
    ckpts = [str(_make_ckpt(root, {"batch_size": 2, "test_dataset": "gtzan", "fold": fold,
                                   "augmentations": AUGS}, name=f"fold{fold}.ckpt", seed=fold))
             for fold in (0, 1)]
    return data, ckpts


def test_compute_paper_metrics_single_matches(tmp_path, monkeypatch, capsys):
    data = tmp_path / "data"
    data.mkdir()
    make_corpus(data, n_pieces=2, frames=300, dataset="gtzan", augmentations={})
    ckpt = _make_ckpt(tmp_path, {"batch_size": 2, "test_dataset": "gtzan"})
    dump = tmp_path / "preds.npz"
    jax_run, port_run = _run_both(
        monkeypatch, capsys,
        ["--models", str(ckpt), "--datasplit", "test", "--data-dir", str(data)], dump)
    _assert_same_pieces(jax_run, port_run)
    assert port_run[1].count("F-measure_beat") == 2 and "gtzan: " in port_run[1]
    got, want = np.load(dump.with_suffix(".port.npz")), np.load(dump.with_suffix(".jax.npz"))
    assert sorted(got.files) == sorted(want.files) and len(got.files) == 2
    for key in got.files:
        assert np.array_equal(got[key], want[key])


def test_compute_paper_metrics_mean_std_matches(tmp_path, monkeypatch, capsys):
    data = tmp_path / "data"
    data.mkdir()
    make_corpus(data, n_pieces=3, frames=280, dataset="alpha", augmentations=AUGS)
    hparams = {"batch_size": 2, "test_dataset": "gtzan", "augmentations": AUGS}
    ckpts = [str(_make_ckpt(tmp_path, hparams, name=f"seed{s}.ckpt", seed=s)) for s in (0, 1)]
    jax_run, port_run = _run_both(
        monkeypatch, capsys, ["--models", *ckpts, "--datasplit", "val", "--data-dir", str(data),
                              "--aggregation-type", "mean-std"])
    _assert_same_pieces(jax_run, port_run)
    assert len(port_run[0]) == 2 and "AMLt_downbeat: " in port_run[1] and "+-" in port_run[1]


def test_compute_paper_metrics_kfold_matches(folds, tmp_path, monkeypatch, capsys):
    data, ckpts = folds
    dump = tmp_path / "kfold.npz"
    jax_run, port_run = _run_both(
        monkeypatch, capsys, ["--models", *ckpts, "--datasplit", "val", "--data-dir", str(data),
                              "--aggregation-type", "k-fold"], dump)
    _assert_same_pieces(jax_run, port_run)
    assert len(port_run[0]) == 2 and "alpha: " in port_run[1]
    got, want = np.load(dump.with_suffix(".port.npz")), np.load(dump.with_suffix(".jax.npz"))
    assert sorted(got.files) == sorted(want.files) and len(got.files) == 4
    for key in got.files:
        assert np.array_equal(got[key], want[key])


def test_compute_paper_metrics_kfold_rejects_repeated_pieces(folds):
    data, ckpts = folds
    args = compute_paper_metrics.get_parser().parse_args(
        ["--models", ckpts[0], ckpts[0], "--datasplit", "val", "--data-dir", str(data),
         "--aggregation-type", "k-fold", "--device", "cpu"])
    with pytest.raises(AssertionError, match="repeated pieces"):
        compute_paper_metrics.main(args)


def _port_trainer_ckpt(root: Path) -> Path:
    """A checkpoint written by the port's trainer, with its resume state."""
    from beat_this_tpu_torch.data import BeatDataModule
    from beat_this_tpu_torch.model.beat_this import BeatThisConfig
    from beat_this_tpu_torch.train.task import TrainConfig
    from beat_this_tpu_torch.train.trainer import Trainer

    dm = BeatDataModule(root / "data", batch_size=2, augmentations={})
    trainer = Trainer(BeatThisConfig(transformer_dim=64, n_layers=1), TrainConfig(), dm,
                      checkpoint_dir=root, name="port", device="cpu")
    return trainer.save_checkpoint(trainer.init_state(), 1)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_clean_checkpoints_loads_in_both_packages(tmp_path, writer):
    if writer == "jax":
        ckpt = _make_ckpt(tmp_path, {"batch_size": 2})
        full = load_torch_checkpoint(ckpt)
        full["beat_this_tpu"] = {"step": 5, "epoch": 1, "opt_leaves": {"0": np.ones(3)}}
        save_torch_checkpoint(full, ckpt)
        resume = "beat_this_tpu"
    else:
        ckpt = _port_trainer_ckpt(tmp_path)
        resume = "beat_this_tpu_torch"
    full = torch.load(ckpt, weights_only=True)
    full["datamodule_hyper_parameters"]["data_dir"] = "/somewhere"
    torch.save(full, ckpt)
    twin = ckpt.with_name("twin.ckpt")
    shutil.copy(ckpt, twin)

    out = clean_checkpoints.clean(ckpt, suffix=True)
    assert out == ckpt.with_suffix(".cleaned.ckpt")
    jax_clean.main(type("A", (), {"checkpoints": [str(twin)], "suffix": False})())
    cleaned, want = load_checkpoint(out), load_torch_checkpoint(twin)
    assert resume in full and sorted(cleaned) == sorted(want) == sorted(
        k for k in clean_checkpoints.KEEP_KEYS if k in full)
    assert "data_dir" not in cleaned["datamodule_hyper_parameters"]
    assert cleaned["hyper_parameters"] == want["hyper_parameters"]
    assert sorted(cleaned["state_dict"]) == sorted(want["state_dict"])
    for k, v in cleaned["state_dict"].items():
        assert np.array_equal(v.numpy(), np.asarray(want["state_dict"][k])), k
    # the cleaned file loads in the port and in the JAX package
    model = load_model(out, "cpu")
    jax_ckpt = load_torch_checkpoint(out)
    params, state = torch_state_dict_to_pytree(
        jax_ckpt["state_dict"], JaxConfig.from_hparams(jax_ckpt["hyper_parameters"]))
    for leaf in ("w", "b"):
        assert np.array_equal(np.asarray(params["head"][leaf]),
                              to_jax(model.state_dict())[0]["head"][leaf])


def test_compare_activations_passes_the_two_clis_and_fails_a_perturbed_dump(
        tmp_path, raw_corpus):  # noqa: F811
    """The port's CLI and the JAX CLI dump one synthetic wav with
    `--activations`; launch_scripts/compare_activations.py exits 0 at the
    float32 tolerance and 1 once one logit moves past it."""
    ckpt = _make_ckpt(tmp_path, {})
    wav = raw_corpus / "raw_audio" / "song1.wav"
    dirs = {name: tmp_path / name for name in ("jax", "port")}
    for name, run in (("jax", jax_cli), ("port", cli.run)):
        dirs[name].mkdir()
        run(inputs=[str(wav)], model=str(ckpt), output=str(dirs[name] / "song1.beats"),
            suffix=".beats", append=False, skip_existing=False, touch_first=False, dbn=False,
            gpu=-1, float16=False, activations=True)

    def compare() -> subprocess.CompletedProcess:
        return subprocess.run(
            [sys.executable, str(LAUNCH / "compare_activations.py"), str(dirs["jax"]),
             str(dirs["port"]), "--tolerance", str(F32_ATOL)],
            capture_output=True, text=True, timeout=60)

    dump = dirs["port"] / "song1.npy"
    logits = np.load(dump)
    assert logits.shape == np.load(dirs["jax"] / "song1.npy").shape == (2, 101)
    ok = compare()
    assert ok.returncode == 0, ok.stdout
    logits[1, 50] += 2 * F32_ATOL
    np.save(dump, logits)
    bad = compare()
    assert bad.returncode == 1 and "FAIL song1.npy" in bad.stdout, bad.stdout


def test_throughput_counts_audio_against_wall_time(monkeypatch):
    clock = iter([10.0])  # the start, then 12.5 s on every reading
    monkeypatch.setattr(profiler.time, "perf_counter", lambda: next(clock, 12.5))
    meter = profiler.Throughput()
    meter.add(30.0)
    meter.add(20.0)
    assert meter.audio_seconds == 50.0
    assert meter.x_realtime == 20.0
    assert meter.summary() == "50.0 s audio in 2.5 s (20.0x real-time)"


def test_maybe_trace_writes_a_trace_only_when_asked(tmp_path, monkeypatch):
    monkeypatch.delenv("BEAT_THIS_TRACE_DIR", raising=False)
    with profiler.maybe_trace():
        torch.ones(4).sum()
    monkeypatch.setenv("BEAT_THIS_TRACE_DIR", str(tmp_path / "traces"))
    with profiler.maybe_trace():
        torch.ones(4).sum()
    traces = list((tmp_path / "traces").glob("trace-*.json"))
    assert len(traces) == 1 and "traceEvents" in traces[0].read_text()


@pytest.mark.parametrize("mode", ["file", "directory"])
def test_cli_prints_the_throughput_summary(tmp_path, raw_corpus, capsys, mode):  # noqa: F811
    ckpt = _make_ckpt(tmp_path, {})
    src = raw_corpus / "raw_audio"
    inputs = [str(src / "song0.wav")] if mode == "file" else [str(src)]
    cli.run(inputs=inputs, model=str(ckpt), output=str(tmp_path / "out"), suffix=".beats",
            append=False, skip_existing=False, touch_first=False, dbn=False, gpu=-1,
            float16=False, activations=False)
    err = capsys.readouterr().err
    seconds = 2.0 if mode == "file" else 4.0
    assert re.search(rf"^{seconds:.1f} s audio in \d+\.\d s \(\d+\.\dx real-time\)$", err,
                     re.MULTILINE), err
