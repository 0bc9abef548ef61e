"""Training task: losses, optimizer, train and eval steps, counterpart of
beat_this_tpu/train/task.py (reference PLBeatThis,
beat_this/model/pl_module.py:21-317):
  * loss = shift-tolerant BCE for beats plus downbeats; the downbeat mask is
    the padding mask times the per-piece has-downbeats flag;
  * AdamW (betas 0.9/0.999, eps 1e-8) with weight decay only on parameters
    of ndim >= 2, and the cosine warmup schedule stepped per optimizer step;
  * gradient accumulation over `accum_steps` microbatches run one after the
    other: batch-norm statistics advance after each, and the gradients are
    averaged (each microbatch's loss is divided by `accum_steps` before its
    backward);
  * data parallelism (`parallel/`): each rank of a `DataGroup` steps on its
    shard of every microbatch through the `DistributedDataParallel` wrapper
    of `parallel.data_parallel`, which all-reduces the gradients once per
    optimizer step, at the last microbatch's backward; the forward takes the
    shard's global first row (dropout masks) and the process group (batch
    norm's statistics), and the returned losses are averaged over the ranks,
    so every rank sees the global batch's losses.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from beat_this_tpu_torch.model.beat_this import BeatThis
from beat_this_tpu_torch.parallel.mesh import DataGroup
from beat_this_tpu_torch.profiler import span
from beat_this_tpu_torch.train.loss import make_losses
from beat_this_tpu_torch.train.schedule import cosine_warmup_scheduler


@dataclass
class TrainConfig:
    """Optimization hyperparameters (defaults = reference train.py)."""

    lr: float = 8e-4
    weight_decay: float = 0.01
    warmup_steps: int = 1000
    max_steps: int = 0  # total optimizer steps (set from epochs * steps/epoch)
    accum_steps: int = 8
    loss_type: str = "shift_tolerant_weighted_bce"
    pos_weight_beat: float = 1.0
    pos_weight_downbeat: float = 1.0
    compute_dtype: str = "float32"  # or "bfloat16"

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def make_optimizer(model: BeatThis, tc: TrainConfig) -> torch.optim.AdamW:
    """AdamW with decay on the parameters of ndim >= 2 only (reference
    pl_module.py:281-296)."""
    params = list(model.parameters())
    return torch.optim.AdamW(
        [{"params": [p for p in params if p.ndim >= 2], "weight_decay": tc.weight_decay},
         {"params": [p for p in params if p.ndim < 2], "weight_decay": 0.0}],
        lr=tc.lr, betas=(0.9, 0.999), eps=1e-8,
    )


def make_scheduler(opt, tc: TrainConfig, last_step: int = -1):
    """The per-step cosine warmup schedule of `opt`; `last_step` as
    `cosine_warmup_scheduler`."""
    return cosine_warmup_scheduler(opt, tc.warmup_steps, max(tc.max_steps, 1), last_step)


def loss_from_outputs(tc: TrainConfig, out: dict, batch: dict) -> dict:
    """Losses given model outputs (reference _compute_loss,
    pl_module.py:99-114)."""
    beat_loss, downbeat_loss = make_losses(
        tc.loss_type, {"beat": tc.pos_weight_beat, "downbeat": tc.pos_weight_downbeat})
    beat_mask = batch["padding_mask"].float()
    downbeat_mask = beat_mask * batch["downbeat_mask"].float()[:, None]
    lb = beat_loss(out["beat"], batch["truth_beat"].float(), beat_mask)
    ld = downbeat_loss(out["downbeat"], batch["truth_downbeat"].float(), downbeat_mask)
    return {"beat": lb, "downbeat": ld, "total": lb + ld}


def accumulate_grads(model: BeatThis, tc: TrainConfig, batch: dict, seeds: list,
                     *, kernels: bool = True, group: Optional[DataGroup] = None) -> dict:
    """Forward and backward of each microbatch of `batch` (leaves shaped
    (accum_steps, micro, ...)) in order, in train mode with dropout seed
    `seeds[i]`, adding the averaged gradients to the parameters' `.grad`.
    Returns the losses averaged over the microbatches (float tensors).

    With a distributed `group`, `batch` is the rank's shard of the global
    batch (rank r holds global rows r * micro onward of every microbatch)
    and `model` the module's `parallel.data_parallel` wrapper: its
    gradient all-reduce runs at the last microbatch's backward only."""
    ddp = group is not None and group.distributed
    parts = []
    for i in range(tc.accum_steps):
        micro = {k: v[i] for k, v in batch.items()}
        last = i == tc.accum_steps - 1
        with span("micro"), \
                model.no_sync() if ddp and not last else contextlib.nullcontext():
            out = model(micro["spect"], compute_dtype=tc.dtype, kernels=kernels, train=True,
                        seed=seeds[i],
                        batch0=group.first_row(len(micro["spect"])) if ddp else 0,
                        group=group.process_group if ddp else None)
            p = loss_from_outputs(tc, out, micro)
            with span("backward"):
                (p["total"] / tc.accum_steps).backward()
        parts.append({k: v.detach() for k, v in p.items()})
    return {k: torch.stack([p[k] for p in parts]).mean() for k in parts[0]}


def global_mean(parts: dict, group: Optional[DataGroup]) -> dict:
    """The ranks' equal-sized shards' mean losses as the global batch's: one
    all-reduce of the stacked values, divided by the ranks."""
    if group is None or not group.distributed:
        return parts
    keys = list(parts)
    stacked = torch.stack([parts[k] for k in keys])
    dist.all_reduce(stacked, group=group.process_group)
    stacked /= group.world
    return dict(zip(keys, stacked.unbind()))


def train_step(model: BeatThis, opt, sched, batch: dict, generator: torch.Generator,
               tc: TrainConfig, *, kernels: bool = True,
               group: Optional[DataGroup] = None) -> dict:
    """One optimizer step over `tc.accum_steps` microbatches: one int32
    dropout seed per microbatch from `generator`, gradients averaged, one
    AdamW update, one schedule step. Returns the mean losses. Data-parallel
    (`group`): as `accumulate_grads`, every rank drawing the same seeds, and
    the losses are the global batch's on every rank."""
    with span("step"):
        seeds = torch.randint(0, 2**31 - 1, (tc.accum_steps,), generator=generator).tolist()
        opt.zero_grad(set_to_none=True)
        parts = global_mean(accumulate_grads(model, tc, batch, seeds, kernels=kernels, group=group),
                            group)
        with span("optimizer"):
            opt.step()
            sched.step()
        return parts


@torch.no_grad()
def eval_step(model: BeatThis, tc: TrainConfig, batch: dict, *, kernels: bool = True):
    """Losses and logits for a batch (no dropout, batch norm in eval)."""
    out = model(batch["spect"], compute_dtype=tc.dtype, kernels=kernels)
    return out, loss_from_outputs(tc, out, batch)
