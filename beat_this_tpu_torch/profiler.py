"""Profiling and throughput observability, counterpart of
beat_this_tpu/profiler.py:
  * `maybe_trace(...)`: context manager that records a `torch.profiler`
    trace (host and, on CUDA, device activity; a Chrome trace viewable in
    Perfetto or chrome://tracing) whenever `BEAT_THIS_TRACE_DIR` is set or a
    directory is passed explicitly;
  * `Throughput`: wall-clock audio-seconds/second counter used by the CLI.

The JAX package's third helper, `maybe_enable_compilation_cache`, has no
counterpart here: the port compiles its kernels once per source hash into
`build/kernels-<hash>/` (`ops/_build.py`) and every later process reuses
that build, so there is no per-process compilation to cache.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None = None):
    """Inside, a torch.profiler trace of the host (and of CUDA when it is
    available) is recorded and written as `trace-<pid>-<time>.json` under
    `trace_dir`, or `$BEAT_THIS_TRACE_DIR`; with neither, nothing is
    recorded."""
    trace_dir = trace_dir or os.environ.get("BEAT_THIS_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace-{os.getpid()}-{time.time_ns()}.json"))


class Throughput:
    """Accumulates processed audio seconds against wall-clock time."""

    def __init__(self):
        self.audio_seconds = 0.0
        self.t0 = time.perf_counter()

    def add(self, audio_seconds: float):
        self.audio_seconds += audio_seconds

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def x_realtime(self) -> float:
        return self.audio_seconds / max(self.elapsed, 1e-9)

    def summary(self) -> str:
        return (
            f"{self.audio_seconds:.1f} s audio in {self.elapsed:.1f} s "
            f"({self.x_realtime:.1f}x real-time)"
        )
