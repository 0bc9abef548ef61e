"""Timing and device choice shared by the bench entry points."""

from __future__ import annotations

import statistics
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
