"""The port's checkpoint resolution (`io.checkpoint.load_checkpoint`) by local
path, URL and released shortname, as beat_this_tpu/inference.py:53-79 and
tests/test_checkpoint_download.py hold the JAX package's, with no network: a
localhost HTTP server stands in for the release host, $BEAT_THIS_CACHE
points into the test's directory and CHECKPOINT_URL at the server. Also the
defaults that rely on it: the class tower and the CLI name `final0`, and
`load_model(None, ...)` builds the default model."""

import threading
from functools import partial
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from beat_this_tpu_torch import cli, inference
from beat_this_tpu_torch.io import checkpoint as ckpt_mod
from beat_this_tpu_torch.io.audio import save_wav
from beat_this_tpu_torch.io.checkpoint import init_beat_this, load_checkpoint
from beat_this_tpu_torch.model.beat_this import BeatThisConfig

SMALL = {"transformer_dim": 64, "n_layers": 1}


class _QuietHandler(SimpleHTTPRequestHandler):
    def log_message(self, *args):  # no per-request stderr noise
        pass


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(base_url, docroot) of a localhost file server publishing one small
    checkpoint as small0.ckpt and as final0.ckpt."""
    docroot = tmp_path_factory.mktemp("release-host")
    sd = init_beat_this(3, BeatThisConfig(**SMALL))
    ckpt = {"state_dict": {"model." + k: v for k, v in sd.items()},
            "hyper_parameters": dict(SMALL), "pytorch-lightning_version": "2.0.0"}
    for name in ("small0", "final0"):
        torch.save(ckpt, docroot / f"{name}.ckpt")
    server = ThreadingHTTPServer(("127.0.0.1", 0), partial(_QuietHandler, directory=str(docroot)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", docroot
    server.shutdown()
    thread.join(timeout=5)


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setenv("BEAT_THIS_CACHE", str(cache))
    return cache


@pytest.fixture()
def release_host(served, cache_dir, monkeypatch):
    monkeypatch.setattr(ckpt_mod, "CHECKPOINT_URL", served[0])
    return served


def test_url_download_then_cache_hit(served, cache_dir):
    base_url, docroot = served
    url = f"{base_url}/small0.ckpt"
    ckpt = load_checkpoint(url)
    assert "state_dict" in ckpt and ckpt["hyper_parameters"]["n_layers"] == 1
    cached = cache_dir / "small0.ckpt"
    assert cached.exists()
    assert not cached.with_suffix(".tmp").exists()  # staging file renamed
    # the second load comes from the cache: with the served file hidden a
    # fetch would fail
    (docroot / "small0.ckpt").rename(docroot / "small0.ckpt.hidden")
    try:
        again = load_checkpoint(url)
        assert set(again["state_dict"]) == set(ckpt["state_dict"])
    finally:
        (docroot / "small0.ckpt.hidden").rename(docroot / "small0.ckpt")


def test_shortname_resolves_against_release_host(release_host, cache_dir):
    model = inference.load_model("small0", "cpu")
    assert model.config.transformer_dim == 64 and model.config.n_layers == 1
    # a shortname caches under the reference's beat_this-<name>.ckpt
    assert (cache_dir / "beat_this-small0.ckpt").exists()


def test_missing_name_raises_and_caches_nothing(release_host, cache_dir):
    with pytest.raises(ValueError, match="Could not load the checkpoint"):
        load_checkpoint("does_not_exist")
    assert not (cache_dir / "beat_this-does_not_exist.ckpt").exists()
    assert not (cache_dir / "beat_this-does_not_exist.tmp").exists()


def test_local_path_loads_as_it_is(served, cache_dir):
    _, docroot = served
    ckpt = load_checkpoint(docroot / "small0.ckpt")
    assert ckpt["hyper_parameters"] == SMALL
    assert not cache_dir.exists()


def _wav(path, seconds=3.0, sr=22050):
    t = np.arange(int(seconds * sr)) / sr
    signal = 0.1 * np.sin(2 * np.pi * 440 * t) * (np.mod(t, 0.5) < 0.05)
    save_wav(path, signal, sr, 16)
    return path


def test_file2beats_default_checkpoint(release_host, cache_dir, tmp_path):
    tracker = inference.File2Beats(device="cpu")
    assert tracker.model.config.transformer_dim == 64
    assert (cache_dir / "beat_this-final0.ckpt").exists()
    beats, downbeats = tracker(_wav(tmp_path / "x.wav"))
    assert np.all(np.diff(beats) > 0) and set(downbeats) <= set(beats)


def test_cli_default_model(release_host, cache_dir, tmp_path):
    args = vars(cli.get_parser().parse_args([str(_wav(tmp_path / "x.wav")), "--gpu", "-1"]))
    assert args["model"] == "final0"
    cli.run(**args)
    assert (tmp_path / "x.beats").exists()
    assert (cache_dir / "beat_this-final0.ckpt").exists()


def test_load_model_none_builds_the_default_model():
    model = inference.load_model(None, "cpu")
    assert model.config == BeatThisConfig()
    want = init_beat_this(0, BeatThisConfig())
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert not model.training
