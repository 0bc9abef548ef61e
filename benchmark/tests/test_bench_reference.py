"""The reference against the port's CPU path (its kernels' plain versions)
at a small size: log-mel, dropout masks, the eval forward (masked pieces
at their own length), a training step's loss and gradients in float32,
and the minimal postprocessor."""

import numpy as np
import pytest
import torch

from conftest import TINY
from harness import weights
from reference import chunks, philox, post
from reference.mel import log_mel
from reference.model import Reference, seed_stream
from reference.train import Step

CFG = {"spect_dim": 128, "ff_mult": 4, "head_dim": 32, "stem_dim": 32,
       "dropout_frontend": 0.1, "dropout_transformer": 0.2, "sum_head": True,
       "partial_transformers": True, **TINY}


@pytest.fixture(scope="module")
def port_model():
    from beat_this_tpu_torch.model.beat_this import BeatThis, BeatThisConfig

    torch.manual_seed(0)
    state = weights.make_state(CFG, 11, "cpu")
    state["frontend.stem.bn1d.running_mean"] = torch.rand(128)
    state["frontend.stem.bn1d.running_var"] = 1.0 + torch.rand(128)
    model = BeatThis(BeatThisConfig(**{k: v for k, v in CFG.items()}))
    model.load_state_dict(state)
    return model, state


def test_log_mel_and_masks_match_the_port():
    from beat_this_tpu_torch.ops import dropout
    from beat_this_tpu_torch.ops.mel import log_mel_spectrogram

    pcm = torch.randint(-20000, 20000, (22050,), dtype=torch.int16)
    # log1p(1000 x) magnifies the convolution's rounding in quiet bins
    assert torch.allclose(log_mel(pcm), log_mel_spectrogram(pcm), rtol=1e-4, atol=1e-3)
    for args in ((123456789, philox.SALT_FREQ, philox.SITE_ATTN_PROBS, 3, 2, 7, 9, 0.1),
                 (2**31 - 5, philox.SALT_FF, philox.SITE_FF_OUT, 1, 1, 33, 130, 0.2)):
        mine = philox.keep_mask(*args, "cpu", item0=5, row0=17)
        theirs = dropout.keep_mask(*args, "cpu", item0=5, row0=17)
        assert torch.equal(mine, theirs > 0)


def test_eval_forward_matches_the_port(port_model):
    model, state = port_model
    ref = Reference(CFG, state)
    x = torch.randn(2, 96, 128) * 2 + 3
    with torch.no_grad():
        beat, down = ref.forward(x)
        out = model(x, kernels=False)
        assert torch.allclose(beat, out["beat"], atol=2e-5, rtol=1e-4)
        assert torch.allclose(down, out["downbeat"], atol=2e-5, rtol=1e-4)
        # a masked window equals a run at the piece's own length
        valid = torch.tensor([96, 50])
        masked = model(x, valid_lengths=valid, kernels=False)
        own, _ = ref.forward(x[1:, :50])
        assert torch.allclose(own[0], masked["beat"][1, :50], atol=2e-5, rtol=1e-4)


def test_chunk_rule_matches_the_port(port_model):
    from beat_this_tpu_torch.inference import ChunkedPredictor

    model, state = port_model
    mel = torch.randn(3100, 128)
    with torch.no_grad():
        beat, down = chunks.predict(Reference(CFG, state), mel)
        pb, pd = ChunkedPredictor(model).predict(mel.numpy())
    assert np.allclose(beat, pb, atol=5e-5) and np.allclose(down, pd, atol=5e-5)


def test_training_step_matches_the_port_in_float32(port_model):
    from beat_this_tpu_torch.train import task

    _, state = port_model
    from beat_this_tpu_torch.model.beat_this import BeatThis, BeatThisConfig

    model = BeatThis(BeatThisConfig(**CFG))
    model.load_state_dict(state)
    g = torch.Generator().manual_seed(3)
    batch = {"spect": torch.randn(2, 2, 512, 128, generator=g),
             "truth_beat": (torch.rand(2, 2, 512, generator=g) < 0.05).float(),
             "truth_downbeat": (torch.rand(2, 2, 512, generator=g) < 0.02).float(),
             "padding_mask": torch.ones(2, 2, 512, dtype=torch.bool),
             "downbeat_mask": torch.ones(2, 2, dtype=torch.bool)}
    tr = {"lr": 8e-4, "weight_decay": 0.01, "warmup_steps": 10, "max_steps": 100,
          "pos_weight_beat": 3.0, "pos_weight_downbeat": 9.0}
    tc = task.TrainConfig(lr=tr["lr"], weight_decay=tr["weight_decay"], warmup_steps=10,
                          max_steps=100, accum_steps=2, pos_weight_beat=3.0,
                          pos_weight_downbeat=9.0)
    opt, gen = task.make_optimizer(model, tc), torch.Generator().manual_seed(9)
    sched = task.make_scheduler(opt, tc)
    losses = [float(task.train_step(model, opt, sched, batch, gen, tc)["total"])
              for _ in range(2)]
    params = {k: v.clone().requires_grad_(not k.endswith(("running_mean", "running_var")))
              for k, v in state.items()}
    step, gen = Step(CFG, params, tr), torch.Generator().manual_seed(9)
    for i in range(2):
        seeds = torch.randint(0, 2**31 - 1, (2,), generator=gen).tolist()
        loss, grads = step.grads([{k: v[j] for k, v in batch.items()} for j in range(2)], seeds)
        assert abs(loss - losses[i]) <= 1e-5 * abs(loss)
        step.update(grads)
    for name, p in model.named_parameters():
        assert torch.allclose(p.detach(), params[name].detach(), atol=1e-6), name


def test_dropout_seeds_follow_the_port():
    from beat_this_tpu_torch.model.beat_this import _Seeds

    ours, theirs = seed_stream(77), _Seeds(77)
    assert [next(ours) for _ in range(5)] == [theirs() for _ in range(5)]


def test_postprocessor_matches_the_port():
    from beat_this_tpu_torch.postprocessing.postprocessor import Postprocessor

    rng = np.random.default_rng(4)
    beat = (rng.standard_normal(3000) * 3).astype(np.float32)
    down = (rng.standard_normal(3000) * 3 - 2).astype(np.float32)
    beat[100:102] = 9.0  # a plateau: two peaks merged
    want = Postprocessor("minimal")(beat, down)
    got = post.beats(beat, down)
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
