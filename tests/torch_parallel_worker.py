"""Processes of tests/test_torch_parallel.py. Imports torch and the port only.

`single(_, root)` runs the port's one-process references (no process
group) and writes them to `root/single.pt`. `run(rank, world, root)` joins
a gloo group through a FileStore under `root`, runs every leg on its shard
of each global batch and writes its results to `root/rank<r>.pt`:

  * "mesh": two train steps of the small model of tests/test_train_step.py
    at dropout 0 (the JAX package's 8-device mesh step is the reference);
  * "dropout": two train steps of a stock model with dropout on, plain
    path, and the same steps with every rank's batch base forced to 0 (the
    negative control: then the ranks draw correlated masks);
  * "predict": sharded `predict_many` on the pieces of
    tests/test_sharded_inference.py, and on a set whose forwards split
    unevenly;
  * "trainer": the port's Trainer on tests/multihost_worker.py's corpus and
    config for 2 epochs, a 1-step run and its resume to 2 epochs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from beat_this_tpu_torch.inference import ChunkedPredictor, _eval_model
from beat_this_tpu_torch.io.checkpoint import init_beat_this
from beat_this_tpu_torch.model.beat_this import BeatThis, BeatThisConfig
from beat_this_tpu_torch.parallel.mesh import DataGroup, data_parallel, make_group, shard_rows
from beat_this_tpu_torch.train.task import TrainConfig, make_optimizer, make_scheduler, train_step

MESH_CONFIG = dict(transformer_dim=64, n_layers=1, dropout_frontend=0.0, dropout_transformer=0.0)
MESH_ACCUM, MESH_MICRO, MESH_T = 2, 8, 64
DROP_CONFIG = dict(transformer_dim=32, n_layers=1)  # the stock dropout rates 0.1 / 0.2
DROP_ACCUM, DROP_MICRO, DROP_T = 2, 4, 64
PIECES = [(300, 150, 97), (300, 150, 97, 250, 60)]


def train_config(accum: int) -> TrainConfig:
    return TrainConfig(max_steps=50, accum_steps=accum, warmup_steps=1)


def synthetic_batch(accum: int, micro: int, t: int, seed: int) -> dict:
    """tests/test_train_step.py:synthetic_batch, (accum, micro, ...) leaves."""
    rng = np.random.RandomState(seed)
    beat = np.zeros((accum, micro, t), np.float32)
    beat[..., ::10] = 1.0
    down = np.zeros((accum, micro, t), np.float32)
    down[..., ::40] = 1.0
    return {
        "spect": rng.randn(accum, micro, t, 128).astype(np.float32),
        "truth_beat": beat,
        "truth_downbeat": down,
        "padding_mask": np.ones((accum, micro, t), np.float32),
        "downbeat_mask": np.ones((accum, micro), np.float32),
    }


class ZeroBase(DataGroup):
    """A group whose every rank draws its dropout masks at batch base 0."""

    def first_row(self, rows: int) -> int:
        return 0


def port_steps(config: dict, accum: int, micro: int, t: int, group=None) -> dict:
    """Two train steps from `init_beat_this(0)` on synthetic batches 1 and 2,
    each rank (of a distributed `group`) on its shard of every microbatch;
    returns the losses of both steps and the final state dict."""
    cfg = BeatThisConfig(**config)
    tc = train_config(accum)
    model = BeatThis(cfg)
    model.load_state_dict(init_beat_this(0, cfg))
    opt = make_optimizer(model, tc)
    sched = make_scheduler(opt, tc)
    replica = model if group is None else data_parallel(model, group)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for seed in (1, 2):
        batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(accum, micro, t, seed).items()}
        if group is not None:
            batch = {k: shard_rows(v.transpose(0, 1), group).transpose(0, 1)
                     for k, v in batch.items()}
        parts = train_step(replica, opt, sched, batch, gen, tc, group=group)
        losses.append({k: float(v) for k, v in parts.items()})
    return {"losses": losses, "state": {k: v.clone() for k, v in model.state_dict().items()}}


def pieces(counts) -> list[np.ndarray]:
    """tests/test_sharded_inference.py's pieces, then any further counts
    from the same stream."""
    rng = np.random.RandomState(0)
    return [rng.randn(t, 128).astype(np.float32) for t in counts]


def predictor_model() -> BeatThis:
    cfg = BeatThisConfig(transformer_dim=64, n_layers=1)
    return _eval_model(cfg, init_beat_this(3, cfg), "cpu")


def predict(counts, group=None) -> list:
    predictor = ChunkedPredictor(predictor_model(), chunk_size=96, border_size=6, group=group)
    return predictor.predict_many(pieces(counts))


def trainer_runs(corpus: Path, tag: str, rank: int = 0,
                 runs=("straight", "first", "resumed")) -> dict:
    """tests/multihost_worker.py's run on the port, `runs` of: 2 epochs
    straight, a 1-step run, and its resume to 2 epochs. The straight run's
    checkpoints go to a directory of the rank's own (`straight<tag><rank>`),
    the 1-step run's to one that every rank reads at resume (`first<tag>`);
    returns the logged losses, final states and which checkpoints exist."""
    from beat_this_tpu_torch.data import BeatDataModule
    from beat_this_tpu_torch.train.trainer import Trainer

    def ckpt_dir(run):
        return corpus / (f"straight{tag}{rank}" if run == "straight" else f"first{tag}")

    def trainer(run):
        dm = BeatDataModule(corpus, batch_size=8, train_length=128, augmentations={},
                            test_dataset=None, seed=0, num_workers=1)
        tc = TrainConfig(accum_steps=1, warmup_steps=2, lr=1e-3, compute_dtype="float32",
                         pos_weight_beat=10, pos_weight_downbeat=40)
        return Trainer(BeatThisConfig(transformer_dim=32, n_layers=1), tc, dm, max_epochs=2,
                       val_frequency=1000, checkpoint_dir=ckpt_dir(run), name="mh",
                       seed=0, device="cpu")

    out = {}
    for run in runs:
        t = trainer(run)
        path = ckpt_dir("first") / "mh-S0.ckpt" if run == "resumed" else None
        state = t.fit(resume_path=path, max_steps_override=1 if run == "first" else None)
        out[run] = {
            "losses": [r["train_loss_total"] for r in t.history if "train_loss_total" in r],
            "step": state.step,
            "state": {k: v.clone() for k, v in state.model.state_dict().items()},
            "ckpt": (ckpt_dir(run) / "mh-S0.ckpt").exists(),
        }
    return out


def single(_, root: str) -> None:
    torch.set_num_threads(1)
    root = Path(root)
    torch.save({
        "dropout": port_steps(DROP_CONFIG, DROP_ACCUM, DROP_MICRO, DROP_T),
        "trainer": trainer_runs(root / "corpus", "-single", runs=("straight",)),
    }, root / "single.pt")


def run(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), world), rank=rank,
                            world_size=world)
    try:
        group = make_group("cpu")
        zero = ZeroBase(group.rank, group.world, group.device, group.process_group)
        out = {
            "world": group.world,
            "mesh": port_steps(MESH_CONFIG, MESH_ACCUM, MESH_MICRO, MESH_T, group),
            "dropout": port_steps(DROP_CONFIG, DROP_ACCUM, DROP_MICRO, DROP_T, group),
            "dropout_base0": port_steps(DROP_CONFIG, DROP_ACCUM, DROP_MICRO, DROP_T, zero),
            "predict": [predict(counts, group) for counts in PIECES],
            "trainer": trainer_runs(root / "corpus", "-dp", rank),
        }
        torch.save(out, root / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
