"""Profiling and throughput observability, counterpart of
beat_this_tpu/profiler.py:
  * `maybe_trace(...)`: context manager that records a `torch.profiler`
    trace (host and, on CUDA, device activity; a Chrome trace viewable in
    Perfetto or chrome://tracing) whenever `BEAT_THIS_TRACE_DIR` is set or a
    directory is passed explicitly;
  * `Throughput`: wall-clock audio-seconds/second counter used by the CLI;
  * `span(name)`: the program's own spans. While a torch.profiler window
    is open (`maybe_trace`, or any other `torch.profiler.profile`), a span
    opens a `record_function` range `bt.<name>`, so it sits in the Chrome
    trace on the kernels' clock, and appends a `Span` (name, start and end
    in `time.time_ns()`, a group's `audio_s`) to the window's `Session`;
    while none is open it is one shared null context;
  * `op_entry`: a span named after a kernel entry point around each call,
    and `range_device_ms`, the device time of the kernels inside each
    entry's range on a profile's device timeline;
  * `counters`: process-wide host counts of the inference forwards, always
    kept (`count`), which a session snapshots at its start.

`time.time_ns()` is the trace's clock: a Chrome trace event's `ts` (us)
times 1000 plus the trace's `baseTimeNanoseconds` is Unix time in ns.

The JAX package's third helper, `maybe_enable_compilation_cache`, has no
counterpart here: the port compiles its kernels once per source hash into
`build/kernels-<hash>/` (`ops/_build.py`) and every later process reuses
that build, so there is no per-process compilation to cache.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import math
import os
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import profiler as autograd_profiler


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
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    _state["on"] = False  # the window's first span opens a new session
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


# -- the program's spans ------------------------------------------------

# what `ChunkedPredictor._forward` counts: its forwards' rows x frames, and
# the frames of masked rows past their `valid_lengths` (padding a bucketed
# forward computes and masks out)
counters = {"forward_frames": 0, "masked_frames": 0}
_counting = threading.Lock()


def count(**increments: int) -> None:
    with _counting:
        for name, n in increments.items():
            counters[name] += n


class Span:
    """One span as recorded, start and end in `time.time_ns()`; `audio_s`
    is set on a `group` span (the seconds of audio its files hold)."""

    __slots__ = ("name", "start_ns", "end_ns", "audio_s")

    def __init__(self, name: str):
        self.name = name
        self.start_ns = self.end_ns = self.audio_s = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Session:
    """The spans of one profiler window, from its first span on, and
    `counters` as they stood then: a reader takes its deltas against the
    live `counters`."""

    def __init__(self):
        self.spans: list[Span] = []
        with _counting:
            self.counters = dict(counters)

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]


class _Off:
    """The span of a process no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, audio_s: float) -> None:
        pass


_OFF = _Off()
_state = {"on": False, "session": None}


def _window_open() -> bool:
    """Whether a torch.profiler window is open in this process: the
    profiler's process-wide flag, which every thread reads alike (its
    thread-local state does not reach a plain Python thread, so
    `_profiler_enabled()` there reads False inside a window)."""
    return autograd_profiler._is_profiler_enabled


class _On:
    __slots__ = ("span", "range")

    def __init__(self, session: Session, name: str):
        self.span, self.range = Span(name), None
        session.spans.append(self.span)

    def __enter__(self):
        self.span.start_ns = time.time_ns()
        self.range = torch.profiler.record_function(f"bt.{self.span.name}")
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.range.__exit__(*exc)
        finally:
            self.span.end_ns = time.time_ns()
        return False

    def set(self, audio_s: float) -> None:
        self.span.audio_s = audio_s


def span(name: str):
    """A context manager around the program's work `name`. While a
    torch.profiler window is open in the process it records a `Span` in
    the window's session and opens the range `bt.<name>` (which reaches
    the trace from the threads the profiler records); otherwise it is one
    shared null context: no allocation, no clock read, no range. A session
    begins with the first span of a window; a span that finds no window
    open, on any thread, ends it."""
    if not _window_open():
        _state["on"] = False
        return _OFF
    if not _state["on"]:
        _state["on"], _state["session"] = True, Session()
    return _On(_state["session"], name)


def session() -> Session | None:
    """The newest session (the spans of the last profiler window that ran
    any), or None while no span was ever recorded."""
    return _state["session"]


def op_entry(fn):
    """`fn`, a kernel entry point, with every call inside `span(fn.__name__)`:
    the kernels it launches fall inside its `bt.<name>` range, also on
    autograd's device thread, so a trace attributes them by range."""
    name = fn.__name__

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return entry


# the kernel entry points (`op_entry`) by the kernel they launch
OP_ENTRIES = {
    "fused_ff": "K1", "fused_time_roformer": "K2", "fused_freq_roformer": "K3",
    "attn_train_fwd": "B4", "attn_train_bwd": "B5", "freq_train_fwd": "B6",
    "freq_train_bwd": "B7", "ff_train_fwd": "B8", "ff_train_bwd": "B9", "flash_fwd": "B10",
    "flash_fwd_lse": "B10", "flash_bwd": "B11", "small_fwd": "B12", "small_bwd": "B12",
}
REST = "rest (outside the kernel entries' ranges)"


def range_device_ms(events, device_ms: float | None = None) -> dict[str, float]:
    """Device ms of each kernel of OP_ENTRIES from a profile's `events()`:
    every device event (kernel, copy, set) that lies on the device's
    timeline inside the device-side span of an entry's `bt.<entry>` range,
    on the same stream, whoever else launches the same kernels (B8's serve
    K1, K2 and B7). The host-side range is not credited with the kernels
    that the port's library launches (a user range correlates them only
    with its device-side span), so its rows in `key_averages()` read no
    device time for them. With the profile's whole `device_ms`, what no
    entry's span holds is `REST`."""
    cpu = torch.autograd.DeviceType.CPU
    spans, device = defaultdict(list), []  # spans by stream: (start, end, kernel)
    for e in events:
        if e.device_type == cpu:
            continue
        if not e.is_user_annotation:
            device.append(e)
        elif e.name.startswith("bt.") and e.name[3:] in OP_ENTRIES:
            spans[e.device_resource_id].append(
                (e.time_range.start, e.time_range.end, OP_ENTRIES[e.name[3:]]))
    for stream in spans.values():
        stream.sort()
    out: dict[str, float] = defaultdict(float)
    for e in device:
        stream = spans.get(e.device_resource_id, [])
        # the entries' spans on one stream do not overlap: the last that
        # starts at or before the event is the only one that can hold it
        i = bisect.bisect_right(stream, (e.time_range.start, math.inf, "")) - 1
        if i >= 0 and e.time_range.end <= stream[i][1]:
            out[stream[i][2]] += (e.time_range.end - e.time_range.start) / 1e3
    if device_ms is not None:
        out[REST] = device_ms - sum(out.values())
    return dict(out)
