"""Data parallelism of the port (`beat_this_tpu_torch/parallel/`) on the CPU:
two ranks spawned by torch.multiprocessing over gloo (a FileStore in the
test's directory, one torch thread each, `tests/torch_parallel_worker.py`)
against the JAX package's runs over its 8-device CPU mesh and against the
port's own one-process runs, on the same numpy-seeded weights and batches.

  * The 2-rank train step against the JAX mesh step of
    tests/test_train_step.py:75-99 at dropout 0 (the two packages' masks
    cannot match bit for bit): losses rtol 2e-4, the head bias atol 1e-5,
    and the batch-norm running statistics atol 1e-5 (as
    tests/test_torch_train_step.py), after two steps.
  * With dropout on (the stock model's rates, plain path), the 2-rank
    steps against the 1-rank steps: losses and every parameter and buffer
    within 1e-5; with every rank's batch base forced to 0 (correlated
    masks) the losses miss that.
  * The port's Trainer on tests/multihost_worker.py's corpus and config:
    both ranks log the same losses, those of the one-process Trainer within
    rtol 2e-4; only rank 0 writes its checkpoint; a 2-rank resume from a
    1-step checkpoint continues as the uninterrupted run does.
  * `python -m beat_this_tpu_torch.train` in two processes from the JAX
    driver's variables (a tcp:// rendezvous on localhost): each prints the
    JAX driver's "Multi-host run" line, and rank 0 alone writes the
    checkpoint.
  * Sharded `predict_many` against the JAX package's
    `ChunkedPredictor(mesh=make_mesh())` on tests/test_sharded_inference.py's
    pieces, and on a set whose forwards split unevenly over the ranks (padding
    rows), atol 5e-5.
The ranks and the port's one-process references run in processes of their
own while this process runs the JAX package's.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

from beat_this_tpu.data.synth import write_click_corpus
from beat_this_tpu.inference import ChunkedPredictor as JaxPredictor
from beat_this_tpu.inference import LoadedModel
from beat_this_tpu.model import BeatThisConfig as JaxConfig
from beat_this_tpu.model import init_beat_this as jax_init
from beat_this_tpu.parallel import make_mesh
from beat_this_tpu.train.task import TrainConfig as JaxTrainConfig
from beat_this_tpu.train.task import init_train_state, make_train_step
from beat_this_tpu_torch.inference import plan_chunks
from beat_this_tpu_torch.io.checkpoint import to_jax
from beat_this_tpu_torch.parallel import distributed
from beat_this_tpu_torch.parallel.mesh import DataGroup, make_group, shard_rows
from tests import torch_parallel_worker as worker

WORLD = 2
RANK_TIMEOUT_S = 300
REPO = Path(__file__).resolve().parent.parent
# the training driver, tiny, on the corpus of tests/multihost_worker.py
DRIVER_ARGS = ["--transformer-dim", "32", "--n-layers", "1", "--no-partial-transformers",
               "--batch-size", "2", "--train-length", "128", "--accumulate-grad-batches", "1",
               "--warmup-steps", "1", "--max-epochs", "1", "--max-steps", "1",
               "--val-frequency", "1", "--precision", "float32", "--no-tempo-augmentation",
               "--no-pitch-augmentation", "--no-mask-augmentation", "--num-workers", "1",
               "--device", "cpu"]
VARIABLES = ("BEAT_THIS_COORDINATOR", "BEAT_THIS_NUM_PROCESSES", "BEAT_THIS_PROCESS_ID",
             "BEAT_THIS_DISTRIBUTED")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _drivers(root: Path) -> list:
    """The training driver started in WORLD processes from the JAX driver's
    variables, each with a checkpoint directory of its own."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in VARIABLES}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", BEAT_THIS_NUM_PROCESSES=str(WORLD),
               BEAT_THIS_COORDINATOR=f"127.0.0.1:{port}")
    return [subprocess.Popen(
        [sys.executable, "-m", "beat_this_tpu_torch.train", "--data-dir", str(root / "corpus"),
         "--checkpoint-dir", str(root / f"driver{r}"), *DRIVER_ARGS],
        env={**env, "BEAT_THIS_PROCESS_ID": str(r)}, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


def _jax_mesh_steps():
    """Two steps of the JAX package's train step over the 8-device mesh, the
    batch's micro axis sharded (tests/test_train_step.py:75-99), at dropout
    0; returns the losses and the final state."""
    jcfg = JaxConfig(**worker.MESH_CONFIG)
    tc = worker.train_config(worker.MESH_ACCUM)
    jtc = JaxTrainConfig(max_steps=tc.max_steps, accum_steps=tc.accum_steps,
                         warmup_steps=tc.warmup_steps)
    params, bn_state = jax_init(0, jcfg)
    mesh = make_mesh()
    assert mesh.devices.size == 8
    batch_sharding, repl = NamedSharding(mesh, P(None, "data")), NamedSharding(mesh, P())
    ts = jax.tree_util.tree_map(lambda x: jax.device_put(x, repl),
                                init_train_state(params, bn_state, jtc))
    step = jax.jit(make_train_step(jcfg, jtc))
    losses = []
    for i, seed in enumerate((1, 2)):
        batch = worker.synthetic_batch(worker.MESH_ACCUM, worker.MESH_MICRO, worker.MESH_T, seed)
        batch = jax.tree_util.tree_map(lambda x: jax.device_put(x, batch_sharding), batch)
        ts, parts = step(ts, batch, jax.random.PRNGKey(i))
        losses.append({k: float(v) for k, v in parts.items()})
    return losses, ts


def _jax_sharded_predictions():
    cfg = JaxConfig(transformer_dim=64, n_layers=1)
    params, state = jax_init(3, cfg)
    predictor = JaxPredictor(LoadedModel(cfg, params, state), chunk_size=96, border_size=6,
                             mesh=make_mesh())
    return [predictor.predict_many(worker.pieces(counts)) for counts in worker.PIECES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the references and the two training drivers' runs."""
    root = tmp_path_factory.mktemp("parallel")
    write_click_corpus(root / "corpus", n_pieces=8, n_val_pieces=1, frames=128)
    drivers = _drivers(root)
    spawned = [mp.start_processes(fn, args=args, nprocs=n, join=False, start_method="spawn")
               for fn, args, n in ((worker.run, (WORLD, str(root)), WORLD),
                                   (worker.single, (str(root),), 1))]
    try:
        refs = {"mesh": _jax_mesh_steps(), "predict": _jax_sharded_predictions()}
    finally:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            for ctx in spawned:
                while not ctx.join(timeout=1):
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"the ranks did not end within {RANK_TIMEOUT_S} s")
            logs = [d.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                    for d in drivers]
        finally:
            for p in (p for ctx in spawned for p in ctx.processes):
                if p.is_alive():
                    p.kill()
            for d in drivers:
                d.kill()
    refs.update(torch.load(root / "single.pt", weights_only=False))
    results = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    drivers = [(d.returncode, log, root / f"driver{r}") for r, (d, log) in
               enumerate(zip(drivers, logs))]
    return results, refs, drivers


def _max_diff(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def _losses(parts):
    return np.array([[p[k] for k in ("beat", "downbeat", "total")] for p in parts])


def test_two_rank_step_equals_the_jax_mesh_step(runs):
    results, refs, _ = runs
    want_losses, ts = refs["mesh"]
    assert all(r["world"] == WORLD for r in results)
    first, second = (r["mesh"] for r in results)
    assert first["losses"] == second["losses"]
    assert _max_diff(first["state"], second["state"]) == 0.0
    np.testing.assert_allclose(_losses(first["losses"]), _losses(want_losses), rtol=2e-4)
    params, bn_state = to_jax(first["state"])
    np.testing.assert_allclose(np.asarray(params["head"]["b"]),
                               np.asarray(ts.params["head"]["b"]), atol=1e-5)
    got_bn = jax.tree_util.tree_leaves(bn_state)
    want_bn = jax.tree_util.tree_leaves(ts.bn_state)
    assert len(got_bn) == len(want_bn) > 0
    for g, w in zip(got_bn, want_bn):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5)


def test_two_ranks_with_dropout_equal_one_rank(runs):
    results, refs, _ = runs
    want = refs["dropout"]
    for r in results:
        np.testing.assert_allclose(_losses(r["dropout"]["losses"]), _losses(want["losses"]),
                                   rtol=0, atol=1e-5)
        assert _max_diff(r["dropout"]["state"], want["state"]) <= 1e-5
    # the negative control: every rank at base 0 drops what rank 0 drops
    base0 = _losses(results[0]["dropout_base0"]["losses"])
    assert np.abs(base0 - _losses(want["losses"])).max() > 1e-5


def test_two_rank_trainer_equals_one_process_trainer(runs):
    results, refs, _ = runs
    want = refs["trainer"]
    first, second = (r["trainer"] for r in results)
    assert first["straight"]["step"] == second["straight"]["step"] == 2
    assert len(want["straight"]["losses"]) == 2
    assert first["straight"]["losses"] == second["straight"]["losses"]
    np.testing.assert_allclose(first["straight"]["losses"], want["straight"]["losses"],
                               rtol=2e-4)
    # rank 0 alone writes (each rank's straight run has a directory of its own)
    assert first["straight"]["ckpt"] and not second["straight"]["ckpt"]
    for r in (first, second):
        assert r["first"]["step"] == 1 and r["first"]["ckpt"]
        assert r["resumed"]["step"] == 2
        assert r["resumed"]["losses"] == r["straight"]["losses"][1:]
        assert _max_diff(r["resumed"]["state"], r["straight"]["state"]) == 0.0


def test_sharded_predict_many_equals_the_jax_mesh(runs):
    results, refs, _ = runs
    # the second set's chunks split unevenly over the ranks: 11 chunks, one short window
    counts = worker.PIECES[1]
    chunks = sum(len(plan_chunks(t, 96, 6)) for t in counts if t > 96 - 12)
    assert chunks % WORLD and sum(t <= 96 - 12 for t in counts) % WORLD
    for i, want in enumerate(refs["predict"]):
        got0, got1 = (r["predict"][i] for r in results)
        assert len(got0) == len(got1) == len(want) == len(worker.PIECES[i])
        for (b0, d0), (b1, d1), (bw, dw) in zip(got0, got1, want):
            np.testing.assert_array_equal(b0, b1)
            np.testing.assert_array_equal(d0, d1)
            np.testing.assert_allclose(b0, np.asarray(bw), atol=5e-5)
            np.testing.assert_allclose(d0, np.asarray(dw), atol=5e-5)


def test_the_training_driver_on_two_processes(runs):
    _, _, drivers = runs
    for rank, (rc, log, ckpts) in enumerate(drivers):
        assert rc == 0, log[-3000:]
        assert f"Multi-host run: process {rank} of {WORLD}, {WORLD} global devices" in log
        assert f"Data-parallel over {WORLD} processes" in log
        assert any(ckpts.glob("*.ckpt")) == (rank == 0), (rank, list(ckpts.glob("*")))
    assert "train_loss_total=" in drivers[0][1] and "train_loss_total=" not in drivers[1][1]


def test_one_process_without_variables_and_uneven_batches(monkeypatch):
    for name in VARIABLES:
        monkeypatch.delenv(name, raising=False)
    assert distributed.maybe_initialize_distributed() is False
    assert distributed.maybe_initialize_distributed() is False
    assert distributed.host_shard() == (0, 1)
    group = make_group("cpu")
    assert (group.rank, group.world, group.distributed) == (0, 1, False)
    assert torch.equal(shard_rows(torch.arange(8), group), torch.arange(8))
    three = DataGroup(1, 3, torch.device("cpu"))
    assert torch.equal(shard_rows(torch.arange(9), three), torch.arange(3, 6))
    with pytest.raises(ValueError, match="batch_size 8 must divide evenly over 3 processes"):
        shard_rows(torch.arange(8), three)


@pytest.mark.parametrize("env,want", [
    ({"BEAT_THIS_COORDINATOR": "10.0.0.1:9876", "BEAT_THIS_NUM_PROCESSES": "2",
      "BEAT_THIS_PROCESS_ID": "1"},
     {"init_method": "tcp://10.0.0.1:9876", "world_size": 2, "rank": 1}),
    ({"BEAT_THIS_DISTRIBUTED": "1"}, {"init_method": "env://"}),
])
def test_the_variables_choose_the_rendezvous(monkeypatch, env, want):
    """The JAX driver's variables give a tcp:// rendezvous, BEAT_THIS_DISTRIBUTED
    torchrun's env:// (the call is recorded, not made)."""
    for name in VARIABLES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    calls = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    assert distributed.maybe_initialize_distributed(backend="gloo") is True
    assert calls == [("gloo", want)]
    assert distributed.default_backend() == "gloo"  # no CUDA here
