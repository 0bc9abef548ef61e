"""Timing, device choice, the card's description and the seed model, shared
by the bench entry points, the kernel gate and the profilers."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def bench_device(name: str) -> torch.device:
    """`name` as a torch.device; raises when CUDA is asked for and absent (a
    bench never falls back to the CPU on its own)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available; "
                           "pass --device cpu to run the plain versions")
    return device


def nvidia_smi_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out[0] if out else "nvidia-smi printed nothing"


def seed_model(config, device):
    """The seed-0 `BeatThis` of `config` (`init_beat_this(0, config)`) on
    `device`, in training mode."""
    from beat_this_tpu_torch.io.checkpoint import init_beat_this
    from beat_this_tpu_torch.model.beat_this import BeatThis

    with torch.device(device):
        model = BeatThis(config)
    model.load_state_dict(init_beat_this(0, config))
    return model


def median_ms(fn, device: torch.device, reps: int = 10, warmup: int = 3) -> float:
    """Median time in ms of one call of `fn` over `reps` timed calls after
    `warmup` calls: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_line(device: torch.device) -> str:
    """What the timings ran on, for the head of a bench's output."""
    if device.type == "cuda":
        return f"device: {torch.cuda.get_device_name(device)}"
    return "device: cpu (plain PyTorch versions; not a measurement of the kernels)"


def wall_ms(fn, device: torch.device, reps: int = 5, warmup: int = 1) -> float:
    """Median host-clock time in ms of `fn` followed by a synchronize of the
    card (none on the CPU), over `reps` calls after `warmup` calls: for
    stages whose time is the host's as much as the card's (copies, whole
    passes)."""
    def synced():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        synced()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        synced()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
