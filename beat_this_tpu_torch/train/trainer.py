"""Training loop: train steps, validation, checkpoints and resume, counterpart
of beat_this_tpu/train/trainer.py (which replaces the reference's
PyTorch-Lightning Trainer, launch_scripts/train.py:118-132).

Batches are assembled on a prefetch thread by the numpy-only
`BeatDataModule` (`data/`, the port's copy of the JAX package's); each
optimizer step runs `train_step` over `accum_steps` microbatches on one
device. Validation runs every `val_frequency` epochs (middle excerpts,
minimal postprocessing, F-measure and friends from `metrics.py`, reference
pl_module.py:207-222), and a Lightning-layout checkpoint (`state_dict` with the `model.` prefix,
`hyper_parameters`) plus the optimizer state, step and epoch for resume is
written after every epoch.

A resumed run continues as the uninterrupted run would: the data iterator
skips the batches the saved steps consumed, and each step's dropout seeds
derive from (seed, step).

Under an initialised torch.distributed group (`parallel/`) the run is data
parallel, one process per device: each rank assembles only its slice of
every global batch (`train_batches(host_shard=...)`), steps through the
model's DistributedDataParallel wrapper (which broadcasts rank 0's
parameters when it wraps them, at init and at resume), and logs the global
batch's losses. Rank 0 alone prints, appends to the log file and writes the
checkpoint, then every rank waits at a barrier, so a resume reads a whole
file. Validation and test run on every rank in eval mode, with no
collective.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from beat_this_tpu_torch.metrics import Metrics
from beat_this_tpu_torch.inference import ChunkedPredictor, resolve_device
from beat_this_tpu_torch.io.checkpoint import init_beat_this, load_checkpoint, model_state_dict
from beat_this_tpu_torch.model.beat_this import BeatThis, BeatThisConfig
from beat_this_tpu_torch.parallel.mesh import data_parallel, make_group
from beat_this_tpu_torch.postprocessing.postprocessor import Postprocessor
from beat_this_tpu_torch.train.task import (
    TrainConfig,
    eval_step,
    make_optimizer,
    make_scheduler,
    train_step,
)


def _prefetch(iterator, depth: int = 2):
    """Run `iterator` on a background thread with a bounded queue."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                q.put(item)
        finally:
            q.put(None)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            yield item
    finally:
        stop.set()


@dataclass
class TrainState:
    model: BeatThis
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


class Trainer:
    def __init__(
        self,
        model_config: BeatThisConfig,
        train_config: TrainConfig,
        datamodule,
        max_epochs: int = 100,
        val_frequency: int = 5,
        checkpoint_dir="checkpoints",
        name: str = "",
        seed: int = 0,
        use_dbn: bool = False,
        eval_trim_beats: float = 5,
        fps: int = 50,
        log_file=None,
        device="cuda",
    ):
        self.model_config = model_config
        self.tc = train_config
        self.dm = datamodule
        self.max_epochs = max_epochs
        self.val_frequency = val_frequency
        self.checkpoint_dir = Path(checkpoint_dir)
        self.name = name or "beat_this_tpu_torch"
        self.seed = seed
        self.fps = fps
        self.use_dbn = use_dbn
        self.eval_trim_beats = eval_trim_beats
        self.device = resolve_device(device)
        self.group = make_group(self.device)
        if self.group.distributed:
            print(f"Data-parallel over {self.group.world} processes")
        self.postprocessor = Postprocessor(type="dbn" if use_dbn else "minimal", fps=fps,
                                           device=self.device)
        self.metrics = Metrics(eval_trim_beats=eval_trim_beats)
        self.log_file = Path(log_file) if log_file else None
        self.history: list[dict] = []
        self.generator = torch.Generator()
        self.wandb_run = None

    def init_wandb(self, project="beat_this_tpu", name=None, resume_id=None):
        """Optional Weights & Biases logging; a no-op when wandb is not
        installed."""
        try:
            import wandb
        except ImportError:
            print("wandb not installed; falling back to stdout/jsonl logging")
            return None
        kwargs = {"id": resume_id, "resume": "must"} if resume_id else {}
        self.wandb_run = wandb.init(project=project, name=name or self.name,
                                    config={**self.hyper_parameters(), **self.dm.hparams()},
                                    **kwargs)
        return self.wandb_run

    def log(self, record: dict):
        record = {k: (float(v) if hasattr(v, "item") else v) for k, v in record.items()}
        self.history.append(record)
        if self.group.rank != 0:
            return
        print(", ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in record.items()), flush=True)
        if self.log_file:
            self.log_file.parent.mkdir(parents=True, exist_ok=True)
            with open(self.log_file, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self.wandb_run is not None:
            self.wandb_run.log(record)

    # -- checkpoints -------------------------------------------------------
    def hyper_parameters(self) -> dict:
        """PLBeatThis's persisted hyperparameters (pl_module.py:22-44), as
        the JAX trainer writes them."""
        c, tc = self.model_config, self.tc
        return {
            "spect_dim": c.spect_dim,
            "fps": self.fps,
            "transformer_dim": c.transformer_dim,
            "ff_mult": c.ff_mult,
            "n_layers": c.n_layers,
            "stem_dim": c.stem_dim,
            "dropout": {"frontend": c.dropout_frontend, "transformer": c.dropout_transformer},
            "lr": tc.lr,
            "weight_decay": tc.weight_decay,
            "pos_weights": {"beat": tc.pos_weight_beat, "downbeat": tc.pos_weight_downbeat},
            "head_dim": c.head_dim,
            "loss_type": tc.loss_type,
            "warmup_steps": tc.warmup_steps,
            "max_epochs": self.max_epochs,
            "use_dbn": self.use_dbn,
            "eval_trim_beats": self.eval_trim_beats,
            "sum_head": c.sum_head,
            "partial_transformers": c.partial_transformers,
        }

    def init_state(self) -> TrainState:
        """The model from `init_beat_this(seed)` (the JAX init's weights for
        the same seed), its optimizer and schedule."""
        model = BeatThis(self.model_config)
        model.load_state_dict(init_beat_this(self.seed, self.model_config))
        model.to(self.device)
        opt = make_optimizer(model, self.tc)
        return TrainState(model, opt, make_scheduler(opt, self.tc))

    def save_checkpoint(self, state: TrainState, epoch: int, path=None) -> Path:
        """Rank 0 writes the checkpoint (every rank holds the same state);
        in a data-parallel run every rank then waits for the write."""
        path = Path(path) if path else self.checkpoint_dir / f"{self.name}-S{self.seed}.ckpt"
        if self.group.rank == 0:
            self._write_checkpoint(state, epoch, path)
        if self.group.distributed:
            dist.barrier(group=self.group.process_group)
        return path

    def _write_checkpoint(self, state: TrainState, epoch: int, path: Path):
        path.parent.mkdir(parents=True, exist_ok=True)
        sd = {"model." + k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        torch.save({
            "state_dict": sd,
            "hyper_parameters": self.hyper_parameters(),
            "datamodule_hyper_parameters": self.dm.hparams(),
            "pytorch-lightning_version": "2.0.0",
            "beat_this_tpu_torch": {
                "step": state.step, "epoch": epoch,
                "optimizer": state.optimizer.state_dict(),
            },
        }, path)

    def load_checkpoint(self, path) -> tuple[TrainState, int]:
        """The state saved by `save_checkpoint` (a checkpoint without resume
        state starts a fresh optimizer at step 0) and its epoch."""
        ckpt = load_checkpoint(path)
        model = BeatThis(self.model_config)
        model.load_state_dict(model_state_dict(ckpt))
        model.to(self.device)
        opt = make_optimizer(model, self.tc)
        extra = ckpt.get("beat_this_tpu_torch")
        if not extra or not extra["step"]:
            return TrainState(model, opt, make_scheduler(opt, self.tc)), 0
        opt.load_state_dict(extra["optimizer"])  # its groups hold initial_lr
        step = int(extra["step"])
        return TrainState(model, opt, make_scheduler(opt, self.tc, step - 1), step), int(
            extra["epoch"])

    # -- main loop ---------------------------------------------------------
    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    def fit(self, resume_path=None, max_steps_override=None) -> TrainState:
        self.dm.setup("fit")
        steps_per_epoch = self.dm.steps_per_epoch(self.tc.accum_steps)
        if steps_per_epoch == 0:
            raise ValueError("dataset too small for one optimizer step")
        self.tc.max_steps = steps_per_epoch * self.max_epochs
        if resume_path:
            state, start_epoch = self.load_checkpoint(resume_path)
        else:
            state, start_epoch = self.init_state(), 0

        replica = data_parallel(state.model, self.group)
        batches = _prefetch(self.dm.train_batches(
            self.tc.accum_steps, seed=self.seed, host_shard=(self.group.rank, self.group.world)))
        for _ in range(state.step):  # the batches the saved steps consumed
            next(batches)
        for epoch in range(start_epoch, self.max_epochs):
            epoch_losses = []
            t0 = time.time()
            data_wait = 0.0
            for _ in range(steps_per_epoch):
                tw = time.time()
                host_batch = next(batches)
                data_wait += time.time() - tw
                self.generator.manual_seed(((self.seed & 0xFFFFFFFF) << 32) | state.step)
                parts = train_step(replica, state.optimizer, state.scheduler,
                                   self._to_device(host_batch), self.generator, self.tc,
                                   group=self.group)
                state.step += 1
                epoch_losses.append(parts)
                if max_steps_override and state.step >= max_steps_override:
                    break
            losses = {
                f"train_loss_{k}": float(np.mean([float(p[k]) for p in epoch_losses]))
                for k in ("beat", "downbeat", "total")
            }
            self.log({
                "epoch": epoch, **losses,
                "lr": float(state.scheduler.get_last_lr()[0]),
                "time_s": round(time.time() - t0, 1),
                # time blocked on host batch assembly: ~0 means the input
                # pipeline keeps ahead of the device
                "data_wait_s": round(data_wait, 3),
            })
            if (epoch + 1) % self.val_frequency == 0:
                self.validate(state, epoch)
            self.save_checkpoint(state, epoch + 1)
            if max_steps_override and state.step >= max_steps_override:
                break
        return state

    def validate(self, state: TrainState, epoch: int) -> dict:
        all_losses, all_metrics = [], []
        for batch in self.dm.val_batches():
            out, parts = eval_step(state.model, self.tc, self._to_device(batch))
            # padded rows of the last batch add nothing to a loss numerator,
            # so rescaling the mean by rows / n_valid is exact
            n_valid = batch.get("n_valid", len(batch["padding_mask"]))
            scale = len(batch["padding_mask"]) / n_valid
            all_losses.append({k: float(v) * scale for k, v in parts.items()})
            beat, downbeat = self.postprocessor(out["beat"].cpu().numpy(),
                                                out["downbeat"].cpu().numpy(),
                                                batch["padding_mask"])
            for i in range(n_valid):
                m_beat = self.metrics(batch["truth_orig_beat"][i], beat[i], step="val")
                m_down = self.metrics(batch["truth_orig_downbeat"][i], downbeat[i], step="val")
                all_metrics.append({**{f"{k}_beat": v for k, v in m_beat.items()},
                                    **{f"{k}_downbeat": v for k, v in m_down.items()}})
        record = {"epoch": epoch}
        if all_losses:
            for k in all_losses[0]:
                record[f"val_loss_{k}"] = float(np.mean([x[k] for x in all_losses]))
        if all_metrics:
            for k in all_metrics[0]:
                record[f"val_{k}"] = float(np.mean([x[k] for x in all_metrics]))
        self.log(record)
        return record

    def test(self, state: TrainState):
        """Full-piece prediction and test metrics on the test split, one piece
        at a time through `ChunkedPredictor` (reference predict/test path,
        pl_module.py:224-277)."""
        self.dm.setup("test")
        predictor = ChunkedPredictor(state.model, compute_dtype=self.tc.dtype)
        piece_metrics, datasets = [], []
        for i in range(len(self.dm.test_dataset)):
            piece = self.dm.test_dataset[i]
            beat, downbeat = self.postprocessor(*predictor.predict(piece["spect"]))
            m_beat = self.metrics(piece["truth_orig_beat"], beat, step="test")
            m_down = self.metrics(piece["truth_orig_downbeat"], downbeat, step="test")
            piece_metrics.append({**{f"{k}_beat": v for k, v in m_beat.items()},
                                  **{f"{k}_downbeat": v for k, v in m_down.items()}})
            datasets.append(piece["dataset"])
        record = {}
        if piece_metrics:
            for k in piece_metrics[0]:
                record[f"test_{k}"] = float(np.mean([x[k] for x in piece_metrics]))
        self.log(record)
        return record, piece_metrics, datasets
