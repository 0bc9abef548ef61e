"""The port's DBN decoder (`beat_this_tpu_torch/postprocessing/dbn.py`)
against the JAX package's on the CPU: the numpy state-space construction
gives the same arrays exactly; on seeded activation tracks (3/4 and 4/4 clicks
plus noise, an all-below-threshold track, a one-frame track, tied
candidates) the decoded beat rows are identical, the final
log-probabilities agree at 1e-4 relative (float32 sums over hundreds of
frames in both), and a batched `decode_many` equals one piece at a time.
The Postprocessor("dbn") of both packages gives equal beat times."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beat_this_tpu.postprocessing.dbn as jax_dbn
from beat_this_tpu.postprocessing import Postprocessor as JaxPostprocessor
from beat_this_tpu_torch.postprocessing import dbn
from beat_this_tpu_torch.postprocessing.postprocessor import Postprocessor


def _clicks(frames, beats_per_bar, period, seed, noise=0.03):
    """[beat-only, downbeat] activations with a click every `period`
    frames, every `beats_per_bar`-th a downbeat, plus uniform noise."""
    rng = np.random.default_rng(seed)
    act = 1e-3 + noise * rng.random((frames, 2))
    for i, t in enumerate(range(period // 2, frames, period)):
        act[t] = (0.02, 0.9) if i % beats_per_bar == 0 else (0.85, 0.02)
    return act


# name -> activations (T, 2)
TRACKS = {
    "4/4 at 120 bpm": _clicks(700, 4, 25, 0),
    "3/4 at 100 bpm": _clicks(600, 3, 30, 1),
    "4/4 noisy": _clicks(500, 4, 20, 2, noise=0.2),
    "3/4 with leading silence": np.concatenate([np.full((80, 2), 1e-3), _clicks(400, 3, 28, 3)]),
    "4/4 long": _clicks(1100, 4, 33, 4),
    "below threshold": np.full((120, 2), 0.01),
    "one frame": np.array([[0.6, 0.1]]),
    "flat (tied candidates)": np.full((90, 2), 0.25),
}


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
def decoders():
    return jax_dbn.DbnDecoder(), dbn.DbnDecoder()


@pytest.mark.parametrize("num_beats", [3, 4])
def test_state_space_equals_the_jax_package(num_beats):
    want = jax_dbn.build_pattern_hmm(num_beats, 55.0, 215.0, 50.0, 100.0)
    got = dbn.build_pattern_hmm(num_beats, 55.0, 215.0, 50.0, 100.0)
    assert (got.num_beats, got.num_states) == (want.num_beats, want.num_states)
    for name in ("state_positions", "from_idx", "log_probs", "pointers"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    act = np.array([[0.01, 0.01], [0.3, 0.01], [0.02, 0.6], [0.01, 0.01]])
    for threshold in (0.05, 0.7):
        a = dbn.threshold_activations(act, threshold)
        b = jax_dbn.threshold_activations(act, threshold)
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]


@pytest.mark.parametrize("name", list(TRACKS))
def test_decoder_equals_the_jax_package(decoders, name):
    jax_decoder, decoder = decoders
    want = jax_decoder(TRACKS[name])
    got = decoder(TRACKS[name])
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["4/4 at 120 bpm", "3/4 at 100 bpm", "flat (tied candidates)"])
def test_forward_scores_and_choices_equal_the_jax_scan(decoders, name):
    """Pattern by pattern: the final scores at 1e-4 relative, the choices
    (also where candidates tie: both take the first) exactly."""
    jax_decoder, decoder = decoders
    act, _ = dbn.threshold_activations(TRACKS[name], 0.05)
    dens = decoder._log_densities(act).astype(np.float32)
    for hmm, tensors in zip(jax_decoder.patterns, decoder._tensors):
        final, choices = dbn.viterbi_forward(
            *tensors, torch.from_numpy(dens[None]), torch.tensor([len(dens)]))
        want_final, want_choices = jax_dbn._viterbi_scan_batched(
            jnp.asarray(hmm.from_idx), jnp.asarray(hmm.log_probs), jnp.asarray(hmm.pointers),
            jnp.asarray(dens[None]), jnp.ones((1, len(dens)), bool), hmm.num_states)
        np.testing.assert_allclose(final.numpy(), np.asarray(want_final), rtol=1e-4)
        assert np.array_equal(choices.numpy(), np.asarray(want_choices))


def test_tied_candidates_take_the_first():
    """Two predecessors with equal scores: the first slot wins, as in
    `jnp.argmax`, and padded frames mark STAY_CHOICE and keep the scores."""
    from_idx = torch.tensor([[0, 1], [1, 0], [2, 2]])
    log_probs = torch.zeros((3, 2))
    pointers = torch.zeros(3, dtype=torch.int64)
    dens = torch.zeros((2, 3, 3))
    final, choices = dbn.viterbi_forward(from_idx, log_probs, pointers, dens,
                                         torch.tensor([3, 1]))
    assert choices.dtype == torch.int8 and choices.shape == (3, 2, 3)
    assert bool((choices[:, 0] == 0).all()) and bool((choices[0, 1] == 0).all())
    assert bool((choices[1:, 1] == dbn.STAY_CHOICE).all())
    assert torch.equal(final[0], final[1])
    path = dbn.viterbi_backtrack(from_idx, choices, torch.tensor([1, 1]))
    assert path.tolist() == [[1, 1], [1, 1], [1, 1]]


def test_decode_many_equals_one_by_one(decoders):
    _, decoder = decoders
    tracks = list(TRACKS.values())
    batched = decoder.decode_many(tracks)
    assert sum(len(got) > 0 for got in batched) == 6
    for track, got in zip(tracks, batched):
        assert np.array_equal(got, decoder(track))


@pytest.mark.parametrize("batched", [False, True])
def test_postprocessor_dbn_equals_the_jax_package(batched):
    """Logits in, beat and downbeat times out: single pieces and a padded
    batch with its mask."""
    rng = np.random.default_rng(5)
    logits = []
    for frames, bpb, period in ((500, 4, 25), (380, 3, 31)):
        act = _clicks(frames, bpb, period, frames)
        beat = np.log(act.sum(1) / (1 - act.sum(1))) + 0.1 * rng.standard_normal(frames)
        down = np.log(act[:, 1] / (1 - act[:, 1])) + 0.1 * rng.standard_normal(frames)
        logits.append((beat.astype(np.float32), down.astype(np.float32)))
    post, jax_post = Postprocessor("dbn"), JaxPostprocessor("dbn")
    if not batched:
        for beat, down in logits:
            got, want = post(beat, down), jax_post(beat, down)
            assert len(got[0]) > 5 and len(got[1]) > 1
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        return
    t_max = max(len(b) for b, _ in logits)
    beat = np.full((2, t_max), -1000.0, np.float32)
    down = np.full((2, t_max), -1000.0, np.float32)
    mask = np.zeros((2, t_max), bool)
    for i, (b, d) in enumerate(logits):
        beat[i, : len(b)], down[i, : len(d)], mask[i, : len(b)] = b, d, True
    got, want = post(beat, down, mask), jax_post(beat, down, mask)
    for i, (b, d) in enumerate(logits):
        single = post(b, d)
        for k in range(2):
            assert np.array_equal(got[k][i], want[k][i]) and np.array_equal(got[k][i], single[k])


def test_unknown_postprocessor_type_raises():
    with pytest.raises(ValueError, match="Invalid postprocessing type"):
        Postprocessor("viterbi")
