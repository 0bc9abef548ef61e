"""The port's training driver end to end on the CPU at a tiny size: two steps
on a click corpus, validation, the saved checkpoint (read by the JAX
package's torch-free loader into identical arrays), resume (equal to the
uninterrupted run), and the stock configuration's frequency blocks in
training going through the fused_freq training op.
"""

import numpy as np
import pytest
import torch

from beat_this_tpu.data.synth import write_click_corpus
from beat_this_tpu.io.torch_ckpt import load_torch_checkpoint, torch_state_dict_to_pytree
from beat_this_tpu.model import BeatThisConfig as JaxConfig
from beat_this_tpu_torch.io.checkpoint import init_beat_this, to_jax
from beat_this_tpu_torch.model.beat_this import BeatThis, BeatThisConfig
from beat_this_tpu_torch.train.__main__ import get_parser, main
from beat_this_tpu_torch.train.schedule import cosine_warmup_factor


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    write_click_corpus(root, n_pieces=8, n_val_pieces=2, frames=300)
    return root


def _run(corpus, ckpt_dir, *extra):
    args = get_parser().parse_args([
        "--data-dir", str(corpus), "--checkpoint-dir", str(ckpt_dir),
        "--transformer-dim", "64", "--n-layers", "1", "--no-partial-transformers",
        "--batch-size", "2", "--train-length", "128", "--accumulate-grad-batches", "2",
        "--warmup-steps", "1", "--max-epochs", "3", "--val-frequency", "1",
        "--precision", "float32", "--no-tempo-augmentation", "--no-pitch-augmentation",
        "--no-mask-augmentation", "--num-workers", "2", "--device", "cpu", *extra,
    ])
    return main(args)


CKPT = "shift_tolerant_weighted_bce-h64-S0.ckpt"


def test_driver_trains_saves_and_resumes(corpus, tmp_path):
    state = _run(corpus, tmp_path / "a", "--max-steps", "2")
    assert state.step == 2
    ckpt = tmp_path / "a" / CKPT
    assert ckpt.exists()

    # the JAX package's torch-free reader sees the same arrays
    raw = load_torch_checkpoint(ckpt)
    cfg = JaxConfig(transformer_dim=64, n_layers=1, partial_transformers=False)
    jparams, jstate = torch_state_dict_to_pytree(raw["state_dict"], cfg)
    params, bn = to_jax(state.model.state_dict())
    for got, want in ((jparams, params), (jstate, bn)):
        flat_g = torch.utils._pytree.tree_leaves(got)
        flat_w = torch.utils._pytree.tree_leaves(want)
        assert len(flat_g) == len(flat_w)
        for g, w in zip(flat_g, flat_w):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert raw["hyper_parameters"]["transformer_dim"] == 64
    assert raw["beat_this_tpu_torch"]["step"] == 2

    # resume to step 3 equals three uninterrupted steps
    resumed = _run(corpus, tmp_path / "a", "--max-steps", "3", "--resume-checkpoint", str(ckpt))
    straight = _run(corpus, tmp_path / "b", "--max-steps", "3")
    assert resumed.step == straight.step == 3
    assert resumed.scheduler.get_last_lr() == straight.scheduler.get_last_lr()
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            straight.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_checkpoint_loads_through_the_port(corpus, tmp_path):
    from beat_this_tpu_torch.inference import Spect2Frames

    _run(corpus, tmp_path, "--max-steps", "1")
    s2f = Spect2Frames(str(tmp_path / CKPT), device="cpu", chunk_size=96)
    beat, downbeat = s2f(np.random.default_rng(0).standard_normal((200, 128)).astype(np.float32))
    assert beat.shape == downbeat.shape == (200,)
    assert np.isfinite(beat).all()


def test_training_the_stock_config_on_cuda_raises(monkeypatch):
    """The stock configuration no longer raises in training: its frequency
    blocks take the fused_freq training op (the CUDA kernels on a card, the
    plain version on this CPU tensor), one call and one dropout seed per
    block, and the model trains with and without partial transformers."""
    from beat_this_tpu_torch.ops import fused_freq

    cfg = BeatThisConfig(transformer_dim=64, n_layers=1)
    model = BeatThis(cfg)
    model.load_state_dict(init_beat_this(0, cfg))
    x = torch.zeros((1, 32, 128))
    calls = []
    real = fused_freq.fused_freq_roformer_train

    def spy(x, attn, ff, cos, sin, rate, seed):
        calls.append((x.shape[1:], rate, seed))
        return real(x, attn, ff, cos, sin, rate, seed)

    monkeypatch.setattr(fused_freq, "fused_freq_roformer_train", spy)
    assert model(x, train=True, seed=0)["beat"].shape == (1, 32)
    assert [c[:2] for c in calls] == [((32, 32), 0.1), ((16, 64), 0.1), ((8, 128), 0.1)]
    assert len({c[2] for c in calls}) == 3 and all(isinstance(c[2], int) for c in calls)
    model(x)  # eval
    nopartial = BeatThisConfig(transformer_dim=64, n_layers=1, partial_transformers=False)
    small = BeatThis(nopartial)
    small.load_state_dict(init_beat_this(0, nopartial))
    assert small(x, train=True, seed=0)["beat"].shape == (1, 32)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 50, 99, 100, 120])
def test_schedule_matches_jax(step):
    from beat_this_tpu.train.schedule import cosine_warmup_schedule

    want = float(cosine_warmup_schedule(1.0, 10, 100)(step))
    # JAX evaluates the cosine in float32: about 1e-7 absolute on a factor <= 1
    assert cosine_warmup_factor(step, 10, 100) == pytest.approx(want, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("loss_type", ["shift_tolerant_weighted_bce",
                                       "splitted_shift_tolerant_weighted_bce",
                                       "weighted_bce", "bce"])
def test_losses_match_jax(loss_type):
    """The port's losses against beat_this_tpu/train/loss.py on the same
    numpy inputs (float32, rtol 1e-6)."""
    import jax.numpy as jnp

    from beat_this_tpu.train.loss import make_losses as jax_make_losses
    from beat_this_tpu_torch.train.loss import make_losses

    rng = np.random.default_rng(4)
    preds = (3 * rng.standard_normal((3, 200))).astype(np.float32)
    targets = np.zeros((3, 200), np.float32)
    targets[:, 5::11] = 1.0
    mask = np.ones((3, 200), np.float32)
    mask[:, -30:] = 0.0
    weights = {"beat": 7.0, "downbeat": 30.0}
    for ours, theirs in zip(make_losses(loss_type, weights), jax_make_losses(loss_type, weights)):
        got = float(ours(torch.from_numpy(preds), torch.from_numpy(targets), torch.from_numpy(mask)))
        want = float(theirs(jnp.asarray(preds), jnp.asarray(targets), jnp.asarray(mask)))
        assert got == pytest.approx(want, rel=1e-6)
