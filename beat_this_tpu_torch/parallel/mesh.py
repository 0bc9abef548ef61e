"""Data-parallel groups, the counterpart of beat_this_tpu/parallel/mesh.py.

The JAX package shards the batch axis of one program over a device mesh
and XLA inserts the gradient all-reduce. The port runs one process per
device, as torch does: every rank holds the whole model, takes its
contiguous slice of each global batch, and `DistributedDataParallel`
all-reduces the gradients once per optimizer step. Two things a plain DDP
wrapper would get wrong follow the global batch instead: batch norm takes
the whole batch's statistics (`model/layers.py:batch_norm_apply`) and every
dropout mask is drawn at global batch coordinates (`ops/dropout.py`, the
model's `batch0`). A `DataGroup` takes the place of the mesh and of its
batch and replicated shardings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataGroup:
    """This process's place in a data-parallel run: its rank, the number of
    ranks, its device, and the torch.distributed process group (None for a
    run of one process, which makes no collective)."""

    rank: int
    world: int
    device: torch.device
    process_group: Optional[object] = None

    @property
    def distributed(self) -> bool:
        return self.process_group is not None

    def first_row(self, rows: int) -> int:
        """The global index of this rank's first row of a batch of which it
        holds `rows`."""
        return self.rank * rows


def make_group(device=None) -> DataGroup:
    """The DataGroup of this process over every rank of the initialised
    default process group (`parallel.distributed.maybe_initialize_distributed`),
    or a group of one process when torch.distributed is not initialised.
    `device` defaults to the rank's (`rank_device`)."""
    from beat_this_tpu_torch.parallel.distributed import rank_device

    if dist.is_available() and dist.is_initialized():
        rank, world, pg = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    else:
        rank, world, pg = 0, 1, None
    device = torch.device(device) if device is not None else rank_device(rank)
    return DataGroup(rank, world, device, pg)


def shard_rows(x, group: DataGroup):
    """The rank's contiguous slice of the leading (batch) axis of `x`, the
    counterpart of `shard_batch`: rank r of n takes rows [r B / n, (r + 1) B
    / n). Raises unless n divides B, as `train_batches` does."""
    if len(x) % group.world:
        raise ValueError(f"batch_size {len(x)} must divide evenly over {group.world} processes")
    per = len(x) // group.world
    return x[group.rank * per : (group.rank + 1) * per]


def data_parallel(model: torch.nn.Module, group: DataGroup) -> torch.nn.Module:
    """`model` as a train step of `group` runs it: wrapped in
    DistributedDataParallel when the group is distributed (its parameters
    and buffers broadcast from rank 0 on wrapping, its gradients averaged
    over the ranks), else `model` itself. The ranks' batch-norm buffers stay
    equal without DDP's broadcast, since every rank updates them from the
    same global statistics."""
    if not group.distributed:
        return model
    from torch.nn.parallel import DistributedDataParallel

    ids = [group.device] if group.device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids, output_device=None,
                                   process_group=group.process_group, broadcast_buffers=False)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def usable_data_devices(batch_size: int, n_devices: Optional[int] = None) -> int:
    """Largest device count <= n_devices that evenly divides `batch_size`
    (data-parallel sharding requires the batch axis to split evenly);
    n_devices defaults to the CUDA devices (1 without any)."""
    if n_devices is None:
        n_devices = max(torch.cuda.device_count(), 1)
    for d in range(min(batch_size, n_devices), 0, -1):
        if batch_size % d == 0:
            return d
    return 1
