"""Spans from the harness's own files, and the reduction of one
torch.profiler window to device busy time, idle gaps and kernel time.

A span wraps one call into the program: host-clock seconds summed by name.
With `sync` (the traced run's window) a span ends with
`torch.cuda.synchronize()`, so it holds the device work it queued; without
(the profiled units) it leaves the program's overlap alone. Either way it
opens a `record_function` range of the same name, by which the trace names
what the host was doing in an idle gap."""

from __future__ import annotations

import contextlib
import json
import re
import time
from collections import defaultdict
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
TOP = 10


class Spans:
    def __init__(self, sync: bool):
        self.sync = sync
        self.seconds: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(f"bench.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.sync:
                    torch.cuda.synchronize()
                self.seconds[name] += time.perf_counter() - t0

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


class Trace:
    """Device events and harness ranges of one profiled window."""

    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        wins = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not wins:
            raise RuntimeError(f"the trace holds no {WINDOW} range")
        self.t0 = float(wins[0]["ts"])
        self.t1 = self.t0 + float(wins[0]["dur"])
        inside = [e for e in xs if e.get("cat") in DEVICE_CATS
                  and self.t0 <= float(e["ts"]) < self.t1]
        self.device = [(e["name"], float(e["ts"]), float(e["dur"])) for e in inside]
        if not any(e["cat"] == "kernel" for e in inside):
            raise RuntimeError("torch.profiler recorded no device event in the traced window: "
                               "no device time, roofline, mfu or idle share can be read")
        self.ranges = [(e["name"][len("bench."):], float(e["ts"]), float(e["dur"])) for e in xs
                       if e.get("cat") == "user_annotation" and e["name"].startswith("bench.")
                       and e["name"] != WINDOW]
        self.busy = self._merge([(ts, ts + d) for _, ts, d in self.device])

    @staticmethod
    def _merge(intervals):
        out = []
        for a, b in sorted(intervals):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(min(b, self.t1) - a for a, b in self.busy) / 1e6

    def kernel_seconds(self, patterns) -> float:
        rx = [re.compile(p) for p in patterns]
        return sum(d for n, _, d in self.device if any(r.search(n) for r in rx)) / 1e6

    def kernel_count(self, pattern) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.device if rx.search(n))

    def device_ops(self) -> list:
        by = defaultdict(float)
        for n, _, d in self.device:
            by[n[:160]] += d / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:TOP]

    def idle_gaps(self) -> list:
        """Idle seconds inside the window, by the innermost harness range
        open at each gap's middle."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        by = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            open_ = [(d, n) for n, ts, d in self.ranges if ts <= mid <= ts + d]
            by[min(open_)[1] if open_ else "outside spans"] += (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:TOP]


def profile(run, path: Path) -> Trace:
    """Run `run()` under torch.profiler inside a `bench.window` range and
    reduce the trace (written to `path`)."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            run()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(Path(path).read_text())["traceEvents"]
    path.unlink()
    return Trace(events)
