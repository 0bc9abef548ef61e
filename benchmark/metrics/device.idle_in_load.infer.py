"""The device while the host loads: the share of the profiled window in
which no kernel, copy or set ran on the card while one of the program's
`load` spans was open, in %.

The trace keeps the harness's ranges on its own clock; the program's spans
are on Unix time. They are aligned by anchors: the offset is the median,
over the units, of the harness's `group` range's start minus the program's
`group` span's start (the first follows the second by the few us of the
harness's call), and every program `group` span, shifted, has to lie
inside its unit's harness range to within TOLERANCE_US, or the reading
fails by name. None where the program records no session (a tree without
its own spans)."""

import statistics

from beat_this_tpu_torch import profiler

NAME = "device.idle_in_load.infer"
TOLERANCE_US = 1000.0


def offset_us(harness: list, program: list) -> float:
    """Trace us minus Unix us: harness `(name, ts, dur)` ranges against the
    program's `group` spans, unit by unit in order."""
    harness = sorted(r for r in harness if r[0] == "group")
    program = sorted(program, key=lambda s: s.start_ns)
    if not program or len(harness) != len(program):
        raise RuntimeError(f"{NAME}: {len(harness)} harness group ranges against "
                           f"{len(program)} program group spans")
    off = statistics.median(h[1] - s.start_ns / 1e3 for h, s in zip(harness, program))
    for (_, ts, dur), s in zip(harness, program):
        a, b = s.start_ns / 1e3 + off, s.end_ns / 1e3 + off
        if a < ts - TOLERANCE_US or b > ts + dur + TOLERANCE_US:
            raise RuntimeError(f"{NAME}: a program group span, aligned, lies outside its "
                               f"unit's harness range ({a - ts:.0f} us to "
                               f"{b - ts - dur:.0f} us past it)")
    return off


def idle_us(busy: list, a: float, b: float) -> float:
    """Of [a, b], the time outside the merged busy intervals."""
    covered = sum(max(0.0, min(hi, b) - max(lo, a)) for lo, hi in busy)
    return (b - a) - covered


def read(ctx):
    session = getattr(profiler, "session", lambda: None)()
    if session is None or ctx.cell.work_name != "audio_s":
        return None
    tr = ctx.trace
    off = offset_us(tr.ranges, session.named("group"))
    idle = 0.0
    for s in session.named("load"):
        a = max(tr.t0, s.start_ns / 1e3 + off)
        b = min(tr.t1, s.end_ns / 1e3 + off)
        if b > a:
            idle += idle_us(tr.busy, a, b)
    return 100.0 * idle / (tr.t1 - tr.t0)
