"""The port's train step against the JAX package's `make_train_step` on the
CPU, at dropout 0, with `accum_steps=2` and the small model of
tests/test_train_step.py, for both `partial_transformers` settings: the
same numpy-seeded initial weights and batches on both sides.

Compared: the losses and every gradient of the first step (the gradients
through `io/checkpoint.to_jax`, against `jax.value_and_grad` of the JAX
package's own `compute_losses` with the same microbatch order), the
batch-norm running statistics after each step, and every parameter after
two steps. Tolerances (float32, sums in another order on each side): losses
rtol 1e-5; gradients max |diff| <= 1e-4 of the tensor's max |value|; running
statistics atol 1e-5; parameters after two steps atol 2e-6 (the updates are
about lr = 1.6e-4 per step, so this holds each update to ~1%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beat_this_tpu.model import BeatThisConfig as JaxConfig
from beat_this_tpu.model import init_beat_this as jax_init
from beat_this_tpu.train.task import TrainConfig as JaxTrainConfig
from beat_this_tpu.train.task import compute_losses, init_train_state, make_train_step
from beat_this_tpu_torch.io.checkpoint import init_beat_this, to_jax
from beat_this_tpu_torch.model.beat_this import BeatThis, BeatThisConfig
from beat_this_tpu_torch.train.task import (
    TrainConfig,
    accumulate_grads,
    make_optimizer,
    make_scheduler,
    train_step,
)

ACCUM, MICRO, T = 2, 2, 64


def synthetic_batch(seed):
    """tests/test_train_step.py:synthetic_batch, (accum, micro, ...) leaves."""
    rng = np.random.RandomState(seed)
    beat = np.zeros((ACCUM, MICRO, T), np.float32)
    beat[..., ::10] = 1.0
    down = np.zeros((ACCUM, MICRO, T), np.float32)
    down[..., ::40] = 1.0
    return {
        "spect": rng.randn(ACCUM, MICRO, T, 128).astype(np.float32),
        "truth_beat": beat,
        "truth_downbeat": down,
        "padding_mask": np.ones((ACCUM, MICRO, T), np.float32),
        "downbeat_mask": np.ones((ACCUM, MICRO), np.float32),
    }


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32) for path, leaf in flat}


def _jax_grads(cfg, tc, params, bn_state, batch):
    """Microbatch-averaged gradients, microbatches in order with the batch
    norm state carried, as make_train_step's scan."""
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, s, b: compute_losses(cfg, tc, p, s, b, train=True, rng=jax.random.PRNGKey(0)),
        has_aux=True,
    ))
    total, state = None, bn_state
    for i in range(tc.accum_steps):
        micro = jax.tree_util.tree_map(lambda x: x[i], batch)
        (_, (state, _)), g = grad_fn(params, state, micro)
        total = g if total is None else jax.tree_util.tree_map(jnp.add, total, g)
    return jax.tree_util.tree_map(lambda g: g / tc.accum_steps, total)


def _port_grads(model):
    sd = dict(model.state_dict())
    for name, p in model.named_parameters():
        sd[name] = p.grad
    return to_jax(sd)[0]


def _assert_trees_close(got, want, *, rel=None, atol=None):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for key in want:
        diff = float(np.abs(got[key] - want[key]).max())
        if rel is not None:
            assert diff <= rel * float(np.abs(want[key]).max()) + 1e-12, (key, diff)
        else:
            assert diff <= atol, (key, diff)


@pytest.mark.parametrize("partial", [False, True])
def test_train_step_matches_jax(partial):
    _train_step_matches_jax(partial_transformers=partial)


def test_train_step_matches_jax_at_head_dim_16():
    """The configuration the fused routers decline: every frequency block
    through `small_attention`, every time block through `attention_block`,
    q/k/v sized from head_dim by `init_beat_this` and `to_jax`."""
    _train_step_matches_jax(head_dim=16)


def _train_step_matches_jax(**config):
    kwargs = dict(transformer_dim=64, n_layers=1, dropout_frontend=0.0,
                  dropout_transformer=0.0, **config)
    jcfg, cfg = JaxConfig(**kwargs), BeatThisConfig(**kwargs)
    jtc = JaxTrainConfig(max_steps=50, accum_steps=ACCUM, warmup_steps=5)
    tc = TrainConfig(max_steps=50, accum_steps=ACCUM, warmup_steps=5)

    params, bn_state = jax_init(0, jcfg)
    ts = init_train_state(params, bn_state, jtc)
    step = jax.jit(make_train_step(jcfg, jtc))

    model = BeatThis(cfg)
    model.load_state_dict(init_beat_this(0, cfg))
    opt = make_optimizer(model, tc)
    sched = make_scheduler(opt, tc)
    gen = torch.Generator().manual_seed(0)

    for i in range(2):
        batch = synthetic_batch(i)
        want_grads = _jax_grads(jcfg, jtc, ts.params, ts.bn_state, batch) if i == 0 else None
        ts, jparts = step(ts, batch, jax.random.PRNGKey(i))
        parts = train_step(model, opt, sched, {k: torch.from_numpy(v) for k, v in batch.items()},
                           gen, tc)
        for k in ("beat", "downbeat", "total"):
            np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)
        if want_grads is not None:
            _assert_trees_close(_port_grads(model), want_grads, rel=1e-4)
        _assert_trees_close(to_jax(model.state_dict())[1], ts.bn_state, atol=1e-5)
    _assert_trees_close(to_jax(model.state_dict())[0], ts.params, atol=2e-6)


def test_accumulate_grads_average_microbatches():
    """accum_steps=2 on one batch equals the mean of the two microbatches'
    separate gradients (BN statistics carried from the first to the second)."""
    cfg = BeatThisConfig(transformer_dim=64, n_layers=1, partial_transformers=False)
    tc = TrainConfig(accum_steps=2)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(3).items()}
    model = BeatThis(cfg)
    model.load_state_dict(init_beat_this(1, cfg))
    accumulate_grads(model, tc, batch, [5, 6])
    both = {n: p.grad.clone() for n, p in model.named_parameters()}

    model2 = BeatThis(cfg)
    model2.load_state_dict(init_beat_this(1, cfg))
    one = TrainConfig(accum_steps=1)
    sums = {}
    for i, seed in enumerate([5, 6]):
        model2.zero_grad()
        accumulate_grads(model2, one, {k: v[i : i + 1] for k, v in batch.items()}, [seed])
        for n, p in model2.named_parameters():
            sums[n] = sums.get(n, 0) + p.grad / 2
    for n in both:
        torch.testing.assert_close(both[n], sums[n], rtol=1e-5, atol=1e-7)
    for n, b in model.named_buffers():
        torch.testing.assert_close(b, dict(model2.named_buffers())[n])
