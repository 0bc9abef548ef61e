"""The port's own copies of the JAX package's framework-free modules give
results identical to their originals on the same inputs: audio loading and
resampling, the beat TSV writer, the metrics, the checkpoint key maps, the
click corpus writer, the training batches of the data module and the DBN
decoder's state-space construction; and the checkpoint release host."""

import time

import jax
import numpy as np
import pytest

import beat_this_tpu.data as jax_data
import beat_this_tpu.inference as jax_inference
import beat_this_tpu.io.audio as jax_audio
import beat_this_tpu.io.torch_ckpt as jax_keys
import beat_this_tpu.metrics as jax_metrics
import beat_this_tpu.ops.resample as jax_resample
import beat_this_tpu.postprocessing.dbn as jax_dbn
import beat_this_tpu.utils as jax_utils
from beat_this_tpu.data.synth import write_click_corpus as jax_write_click_corpus
from beat_this_tpu.model import BeatThisConfig, init_beat_this
from beat_this_tpu_torch import data, metrics, utils
from beat_this_tpu_torch.data.synth import write_click_corpus
from beat_this_tpu_torch.io import audio, checkpoint, keys
from beat_this_tpu_torch.ops import resample
from beat_this_tpu_torch.postprocessing import dbn


def _signal(n, seed, channels=1):
    rng = np.random.default_rng(seed)
    return np.clip(0.3 * rng.standard_normal((n, channels)), -1, 1).squeeze()


@pytest.mark.parametrize("bits,channels", [(16, 1), (16, 2), (32, 1)])
def test_load_audio_matches(tmp_path, bits, channels):
    """int16 and float32 wavs, mono and stereo, in both dtypes."""
    path = tmp_path / "x.wav"
    audio.save_wav(path, _signal(4410, bits + channels, channels), 44100, bits)
    ref = tmp_path / "ref.wav"
    jax_audio.save_wav(ref, _signal(4410, bits + channels, channels), 44100, bits)
    assert path.read_bytes() == ref.read_bytes()
    for dtype in ("float64", "float32"):
        got, sr = audio.load_audio(path, dtype)
        want, want_sr = jax_audio.load_audio(path, dtype)
        assert sr == want_sr == 44100
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("in_rate", [44100, 48000])
def test_resample_matches(in_rate):
    x = _signal(in_rate // 5 + 7, in_rate)
    got = resample.resample(x, in_rate=in_rate, out_rate=22050)
    want = jax_resample.resample(x, in_rate=in_rate, out_rate=22050)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_save_beat_tsv_bytes(tmp_path):
    beats = np.array([0.52, 1.04, 1.56, 2.08, 2.6, 3.12, 3.64, 4.16, 4.68])
    downbeats = beats[1::4]
    utils.save_beat_tsv(beats, downbeats, tmp_path / "a.beats")
    jax_utils.save_beat_tsv(beats, downbeats, tmp_path / "b.beats")
    assert (tmp_path / "a.beats").read_bytes() == (tmp_path / "b.beats").read_bytes()
    assert np.array_equal(utils.index_to_framewise(np.array([1, 5, 9]), 12),
                          jax_utils.index_to_framewise(np.array([1, 5, 9]), 12))


@pytest.mark.parametrize("step", ["val", "test"])
def test_metrics_match(step):
    rng = np.random.default_rng(3)
    truth = np.arange(0.5, 40.0, 0.5)
    preds = np.sort(truth + 0.03 * rng.standard_normal(len(truth)))
    for t, p in ((truth, preds), (truth, preds[::2]), (truth, preds * 1.5), (truth, preds[:0])):
        assert metrics.Metrics(5.0)(t, p, step) == jax_metrics.Metrics(5.0)(t, p, step)


@pytest.mark.parametrize("partial", [True, False])
def test_key_maps_round_trip(partial):
    cfg = BeatThisConfig(transformer_dim=64, n_layers=2, partial_transformers=partial)
    params, state = init_beat_this(3, cfg)
    params, state = jax.tree_util.tree_map(np.asarray, (params, state))
    sd = keys.pytree_to_torch_state_dict(params, state)
    want = jax_keys.pytree_to_torch_state_dict(params, state)
    assert sd.keys() == want.keys()
    assert all(np.array_equal(sd[k], want[k]) and sd[k].dtype == want[k].dtype for k in sd)
    lightning = {"model." + k: v for k, v in sd.items()}
    lightning["beat_loss.pos_weight"] = np.ones(1)
    assert keys._strip_keys(lightning).keys() == jax_keys._strip_keys(lightning).keys()
    got = keys.torch_state_dict_to_pytree(lightning, cfg)
    back = jax_keys.torch_state_dict_to_pytree(lightning, cfg)
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    flat_init = jax.tree_util.tree_leaves((params, state))
    assert tree_got == tree_back
    for a, b, c in zip(flat_got, flat_back, flat_init):
        assert np.array_equal(a, b) and np.array_equal(a, c)


# any fixed instant: the clock both corpus writers see
PINNED_CLOCK = 1_700_000_000.0


def _write_corpora(tmp_path, between=None):
    """Write the port's and the JAX package's click corpora into tmp_path / "a"
    and "b" (calling `between()` after the first); return their file lists.

    `ZipFile.writestr` stamps each .npz member with time.localtime(time.time())
    at 2-second resolution, so corpora written on either side of a 2-second
    boundary differ in those stamps alone; the caller pins the clock."""
    ours = write_click_corpus(tmp_path / "a", n_pieces=3, n_val_pieces=1, frames=300, seed=4)
    if between is not None:
        between()
    theirs = jax_write_click_corpus(tmp_path / "b", n_pieces=3, n_val_pieces=1, frames=300,
                                    seed=4)
    assert ours == theirs
    return [sorted(p.relative_to(tmp_path / d) for p in (tmp_path / d).rglob("*") if p.is_file())
            for d in ("a", "b")]


def test_click_corpus_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: PINNED_CLOCK)
    files, theirs = _write_corpora(tmp_path)
    assert files == theirs
    for rel in files:
        assert (tmp_path / "a" / rel).read_bytes() == (tmp_path / "b" / rel).read_bytes(), rel


def test_click_corpus_bytes_across_a_clock_boundary(tmp_path, monkeypatch):
    """The second corpus is written only once the real clock has entered a
    later 2-second window than the first one ended in; under the pinned
    clock the bytes still agree."""
    real_time = time.time
    monkeypatch.setattr(time, "time", lambda: PINNED_CLOCK)
    windows = []

    def wait_for_the_next_window():
        first = int(real_time() // 2)
        while int(real_time() // 2) == first:
            time.sleep(0.02)
        windows.extend([first, int(real_time() // 2)])

    files, theirs = _write_corpora(tmp_path, wait_for_the_next_window)
    assert windows[1] > windows[0]
    assert files == theirs and files
    for rel in files:
        assert (tmp_path / "a" / rel).read_bytes() == (tmp_path / "b" / rel).read_bytes(), rel


def test_data_module_batches(tmp_path):
    """Training batches for one seed, with the augmentations the corpus can
    serve (masking), and the positive weights, are identical."""
    write_click_corpus(tmp_path, n_pieces=6, n_val_pieces=2, frames=400, seed=1)
    modules = []
    for mod in (data, jax_data):
        dm = mod.BeatDataModule(tmp_path, batch_size=2, train_length=128, num_workers=2,
                                augmentations={"mask": {"kind": "permute", "min_count": 1,
                                                        "max_count": 3, "min_len": 0.1,
                                                        "max_len": 0.2, "min_parts": 3,
                                                        "max_parts": 6}},
                                length_based_oversampling_factor=0.65, seed=5)
        dm.setup("fit")
        modules.append(dm)
    ours, theirs = (dm.train_batches(2, seed=7) for dm in modules)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
            else:  # lists of per-item arrays or names
                np.testing.assert_equal(a[k], b[k], err_msg=k)
    assert (modules[0].get_train_positive_weights(widen_target_mask=3)
            == modules[1].get_train_positive_weights(widen_target_mask=3))


@pytest.mark.parametrize("num_beats,fps,bpm,lam", [(3, 50.0, (55.0, 215.0), 100.0),
                                                   (4, 50.0, (55.0, 215.0), 100.0),
                                                   (4, 100.0, (60.0, 180.0), 50.0)])
def test_dbn_state_space_matches(num_beats, fps, bpm, lam):
    """The bar-pointer state space, its transitions and its observation
    pointers, array by array, and the activation trimming."""
    got = dbn.build_pattern_hmm(num_beats, *bpm, fps, lam)
    want = jax_dbn.build_pattern_hmm(num_beats, *bpm, fps, lam)
    assert (got.num_beats, got.num_states) == (want.num_beats, want.num_states)
    for name in ("state_positions", "from_idx", "log_probs", "pointers"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
    assert dbn.STAY_CHOICE == jax_dbn.STAY_CHOICE
    act = np.random.default_rng(num_beats).random((50, 2)) * 0.2
    for threshold in (0.05, 0.15, 0.5):
        a = dbn.threshold_activations(act, threshold)
        b = jax_dbn.threshold_activations(act, threshold)
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]


def test_checkpoint_url_matches():
    """The release host the port fetches shortnames from is the JAX package's."""
    assert checkpoint.CHECKPOINT_URL == jax_inference.CHECKPOINT_URL
