"""The device while the host loads, in a directory cell: the share of the
profiled window in which no kernel, copy or set ran on the card while any
of the program's `load` spans was open, in %. The `load` spans are merged
first, so loads that overlap each other count their time once.

The trace keeps the harness's ranges on its own clock; the program's spans
are on Unix time. One harness `call` range holds one `process_many` call,
and so several program `group` spans. The clocks are aligned by the first
`group` span of each call: the offset is the median, over the calls, of the
`call` range's start minus that span's start (the first follows the second
by the few us of the harness's call), and every program `group` span,
shifted, has to lie inside its call's range to within TOLERANCE_US, or the
reading fails by name. None where the program records no session (a tree
without its own spans)."""

import statistics
from pathlib import Path

from beat_this_tpu_torch import profiler
from harness.registry import load_module
from harness.trace import Trace

NAME = "device.idle_in_load.dir"
TOLERANCE_US = 1000.0
idle_us = load_module(Path(__file__).with_name("device.idle_in_load.infer.py")).idle_us


def offset_us(harness: list, program: list) -> float:
    """Trace us minus Unix us: harness `(name, ts, dur)` ranges against the
    program's `group` spans, each call's first span as its anchor."""
    calls = sorted(r for r in harness if r[0] == "call")
    program = sorted(program, key=lambda s: s.start_ns)
    if not calls or not program:
        raise RuntimeError(f"{NAME}: {len(calls)} harness call ranges, "
                           f"{len(program)} program group spans")
    coarse = calls[0][1] - program[0].start_ns / 1e3
    inside = [[] for _ in calls]
    for s in program:
        a = s.start_ns / 1e3 + coarse
        k = next((k for k, (_, ts, dur) in enumerate(calls)
                  if ts - TOLERANCE_US <= a <= ts + dur + TOLERANCE_US), None)
        if k is None:
            raise RuntimeError(f"{NAME}: a program group span, aligned, starts in no "
                               f"call range ({a - calls[0][1]:.0f} us after the first)")
        inside[k].append(s)
    if not all(inside):
        raise RuntimeError(f"{NAME}: {sum(not g for g in inside)} of {len(calls)} harness "
                           f"call ranges hold no program group span")
    off = statistics.median(ts - g[0].start_ns / 1e3 for (_, ts, _), g in zip(calls, inside))
    for (_, ts, dur), spans in zip(calls, inside):
        for s in spans:
            a, b = s.start_ns / 1e3 + off, s.end_ns / 1e3 + off
            if a < ts - TOLERANCE_US or b > ts + dur + TOLERANCE_US:
                raise RuntimeError(f"{NAME}: a program group span, aligned, lies outside its "
                                   f"call's harness range ({a - ts:.0f} us to "
                                   f"{b - ts - dur:.0f} us past it)")
    return off


def read(ctx):
    session = getattr(profiler, "session", lambda: None)()
    if session is None or ctx.cell.work_name != "audio_s":
        return None
    tr = ctx.trace
    off = offset_us(tr.ranges, session.named("group"))
    loads = Trace._merge([(s.start_ns / 1e3 + off, s.end_ns / 1e3 + off)
                          for s in session.named("load")])
    idle = sum(idle_us(tr.busy, max(tr.t0, a), min(tr.t1, b)) for a, b in loads
               if min(tr.t1, b) > max(tr.t0, a))
    return 100.0 * idle / (tr.t1 - tr.t0)
