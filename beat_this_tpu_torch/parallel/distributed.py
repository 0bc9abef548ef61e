"""Multi-process data parallelism, the counterpart of
beat_this_tpu/parallel/distributed.py, on torch.distributed with one process
per device.

  * `maybe_initialize_distributed()` initialises the default process group
    when the environment asks for it, from the JAX package's own variables:
    BEAT_THIS_COORDINATOR (host:port of rank 0), BEAT_THIS_NUM_PROCESSES and
    BEAT_THIS_PROCESS_ID give `init_method="tcp://host:port"`;
    BEAT_THIS_DISTRIBUTED=1 gives `env://`, the variables torchrun sets
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), where the JAX package
    autodetects a TPU pod.
  * Every process derives the same global batch order from the shared seed
    and materializes only its slice of each global batch
    (`BeatDataModule.train_batches(host_shard=host_shard())`). The JAX
    package then assembles one global array (`shard_host_batch`); here each
    rank keeps its slice on its own device and the collectives join them
    (the gradient all-reduce, batch norm's statistics), so that function has
    no counterpart.
  * Rank 0 alone logs and writes checkpoints (`train/trainer.py`).

Launch recipe (2 processes; on one host, or one per host):

    BEAT_THIS_COORDINATOR=host0:9876 BEAT_THIS_NUM_PROCESSES=2 \
    BEAT_THIS_PROCESS_ID=0 python -m beat_this_tpu_torch.train ...
    # and the same command with BEAT_THIS_PROCESS_ID=1

or `BEAT_THIS_DISTRIBUTED=1 torchrun --nproc-per-node 2 -m
beat_this_tpu_torch.train ...`.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def default_backend() -> str:
    """NCCL for CUDA tensors and gloo for CPU tensors on a machine with
    CUDA; gloo alone without."""
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def maybe_initialize_distributed(backend=None) -> bool:
    """Initialise the default process group if the environment asks for it
    (module docstring); `backend` overrides `default_backend()` (gloo lets
    two ranks share one card). Returns True when the run is multi-process:
    False with none of the variables set, True again on a second call."""
    if dist.is_initialized():
        return True
    backend = backend or default_backend()
    if os.environ.get("BEAT_THIS_COORDINATOR"):
        dist.init_process_group(
            backend,
            init_method=f"tcp://{os.environ['BEAT_THIS_COORDINATOR']}",
            world_size=int(os.environ["BEAT_THIS_NUM_PROCESSES"]),
            rank=int(os.environ["BEAT_THIS_PROCESS_ID"]),
        )
        return True
    if os.environ.get("BEAT_THIS_DISTRIBUTED"):
        dist.init_process_group(backend, init_method="env://")
        return True
    return False


def host_shard() -> tuple[int, int]:
    """(rank, world size): the slice of each global batch this process
    materializes; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(rank=None) -> torch.device:
    """The rank's device: cuda:(LOCAL_RANK, else the rank) modulo the
    visible cards, or the CPU without CUDA."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if rank is None:
        rank = host_shard()[0]
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())
