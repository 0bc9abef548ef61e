"""The PyTorch CLI against the JAX CLI on the CPU (`--gpu -1`): a synthetic
checkpoint written with torch.save and synthetic wavs (a short piece and a
two-chunk piece) must give identical .beats files."""

import numpy as np
import pytest
import torch

from beat_this_tpu.cli import run as jax_run
from beat_this_tpu.io.audio import save_wav
from beat_this_tpu.io.torch_ckpt import pytree_to_torch_state_dict
from beat_this_tpu.model import BeatThisConfig, init_beat_this
from beat_this_tpu_torch.cli import get_parser, run

HPARAMS = {"transformer_dim": 64, "n_layers": 1}


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
def ckpt_path(tmp_path_factory):
    params, state = init_beat_this(13, BeatThisConfig(**HPARAMS))
    sd = pytree_to_torch_state_dict(params, state)
    ckpt = {
        "state_dict": {"model." + k: torch.as_tensor(np.array(v)) for k, v in sd.items()},
        "hyper_parameters": HPARAMS,
    }
    path = tmp_path_factory.mktemp("ckpt") / "tiny.ckpt"
    torch.save(ckpt, path)
    return str(path)


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    for name, seconds in (("short.wav", 1.5), ("long.wav", 31.0)):
        t = np.arange(int(22050 * seconds)) / 22050.0
        clicks = (np.sin(2 * np.pi * 2 * t) > 0.95) * np.sin(2 * np.pi * 1000 * t)
        x = 0.1 * np.sin(2 * np.pi * 220 * t) + 0.3 * clicks + 0.01 * rng.standard_normal(len(t))
        save_wav(d / name, x, 22050)
    return d


def _args(inputs, ckpt, output, **kw):
    args = dict(
        inputs=inputs, model=ckpt, output=output, suffix=".beats", append=False,
        skip_existing=False, touch_first=False, dbn=False, gpu=-1, float16=False,
        activations=False,
    )
    args.update(kw)
    return args


@pytest.mark.parametrize("name", ["short.wav", "long.wav"])
def test_beats_files_equal_jax_cli(ckpt_path, wav_dir, tmp_path, name):
    wav = str(wav_dir / name)
    run(**_args([wav], ckpt_path, str(tmp_path / "torch.beats")))
    jax_run(**_args([wav], ckpt_path, str(tmp_path / "jax.beats")))
    got = (tmp_path / "torch.beats").read_text()
    assert got and got == (tmp_path / "jax.beats").read_text()


def test_directory_mode_and_activations(ckpt_path, wav_dir, tmp_path):
    run(**_args([str(wav_dir)], ckpt_path, str(tmp_path), activations=True))
    for name in ("short", "long"):
        assert (tmp_path / f"{name}.beats").read_text()
        logits = np.load(tmp_path / f"{name}.npy")
        assert logits.shape[0] == 2 and np.isfinite(logits).all()


def test_parser_flags():
    args = get_parser().parse_args(["a.wav", "--gpu", "-1", "--float16", "--no-dbn"])
    assert args.gpu == -1 and args.float16 and not args.dbn


def test_dbn_not_ported(ckpt_path, wav_dir, tmp_path):
    """`--dbn` (which raised while the decoder was not ported) writes the
    JAX CLI's .beats file."""
    wav = str(wav_dir / "long.wav")
    run(**_args([wav], ckpt_path, str(tmp_path / "torch.beats"), dbn=True))
    jax_run(**_args([wav], ckpt_path, str(tmp_path / "jax.beats"), dbn=True))
    assert (tmp_path / "torch.beats").read_text() == (tmp_path / "jax.beats").read_text()


@pytest.mark.parametrize("dbn", [False, True])
def test_directory_mode_equals_single_files(ckpt_path, wav_dir, tmp_path, dbn):
    """The batched directory run writes, byte for byte, what one run per
    file writes (which the tests above hold to the JAX CLI)."""
    run(**_args([str(wav_dir)], ckpt_path, str(tmp_path / "dir"), dbn=dbn, batch_files=2))
    for name in ("short", "long"):
        single = tmp_path / f"{name}.beats"
        run(**_args([str(wav_dir / f"{name}.wav")], ckpt_path, str(single), dbn=dbn))
        got = (tmp_path / "dir" / f"{name}.beats").read_bytes()
        assert got and got == single.read_bytes()


def test_directory_mode_reports_a_bad_file(ckpt_path, wav_dir, tmp_path, capsys):
    """A file that cannot be read is reported and skipped; the others of its
    group are still written."""
    src = tmp_path / "in"
    src.mkdir()
    (src / "a.wav").write_bytes((wav_dir / "short.wav").read_bytes())
    (src / "b.wav").write_bytes(b"not audio")
    run(**_args([str(src)], ckpt_path, str(tmp_path / "out")))
    assert (tmp_path / "out" / "a.beats").exists()
    assert not (tmp_path / "out" / "b.beats").exists()
    assert "b.wav failed" in capsys.readouterr().err
