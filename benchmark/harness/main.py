"""One run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (process start to the window: imports, the inputs made from the
seed, the program's load, the warm-up of every shape the cell uses), then
whole units (a group of files, an optimizer step) until `--seconds` have
passed: each rate is all the work completed over the time from the
window's start to the end of the last unit. `--trace 1` runs the same
window with spans that synchronize, then a torch.profiler window of a few
units with spans that do not (so the trace keeps the program's own overlap
of host and device), and reports the per-layer metrics instead. Once the window has
closed and the program is freed, the reference checks what the window
produced. The last line of standard output is the result; the numbers
compared, each beside its limit, close standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "beat_this_tpu")
PROFILED_UNITS = {"library": 3, "train": 2, "directory": 1}


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.split("\n")[0]
    except (OSError, subprocess.SubprocessError):
        return "unread"


def window(cell, seconds: float):
    """Whole units until `seconds` have passed: (units, work, elapsed)."""
    cell.window_started()
    if cell.spans is not None:
        cell.spans.seconds.clear()
    t0 = time.perf_counter()
    units, work = 0, 0.0
    while True:
        work += cell.unit()
        units += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return units, work, elapsed


def build(reg, cell_name: str, seed: int, device, workdir: Path, trace: bool):
    from harness.directory import Directory
    from harness.library import Library
    from harness.trace import Spans
    from harness.training import Training

    cell = reg.cell(cell_name)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    kind = {"library": Library, "train": Training, "directory": Directory}[traffic["kind"]]
    return kind(cfg, traffic, seed, device, workdir, Spans(sync=True) if trace else None)


def run(argv=None, *, started: float, device=None, reg=None, patch=None,
        control: str | None = None) -> dict:
    """One run; returns the result. `started`: the epoch second the process
    started. `device` None: the first CUDA card, and
    no result without one. `patch(cell)` (tests, `faults`) changes the
    program once it is built, before its first compared work. `control`: a
    lower precision ("tf32", "fp8") in which the reference is also computed
    in the program's place, its readings under "control" (the benchmark's
    own runs never ask for it)."""
    import torch

    from harness.registry import Registry
    from harness import trace as tr

    args = parse(argv)
    reg = reg or Registry()
    spec = reg.cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("benchmark: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < spec["chips"]:
            raise SystemExit(f"benchmark: {spec['chips']} cards asked for, "
                             f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    limits = reg.limits(args.workload)
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        cell = build(reg, args.workload, args.seed, device, Path(tmp), bool(args.trace))
        cell.setup()
        if patch is not None:
            patch(cell)
        cell.prime()
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - started
        units, work, elapsed = window(cell, args.seconds)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        metrics = {}
        if not args.trace:
            values = dict(cell.e2e(work, elapsed), setup_s=setup_s, peak_mem_gib=peak / 2**30)
            for m in reg.metrics("end_to_end", args.workload):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        busy = breakdown = None
        if args.trace:
            ctx = Context(reg, cell, args.workload, units, work, elapsed)
            n0, w0 = len(cell.forwards), len(cell.model_work)
            c0 = ctx.read_counters()
            kind = reg.traffic(spec["traffic"])["kind"]
            cell.spans.sync = False
            ctx.trace = tr.profile(lambda: [cell.unit() for _ in range(PROFILED_UNITS[kind])],
                                   Path(tmp) / "trace.json")
            ctx.profiled, ctx.model_work = cell.forwards[n0:], cell.model_work[w0:]
            ctx.launches = {k: v - c0[k] for k, v in ctx.read_counters().items()}
            for m in reg.metrics("per_layer", args.workload):
                value = reg.reader(m["name"]).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            busy, breakdown = ctx.trace.busy_s, {"device_ops": ctx.trace.device_ops(),
                                                 "idle_gaps": ctx.trace.idle_gaps()}
        attempted, failed = cell.attempted, cell.failed
        for line in sorted(set(getattr(cell, "errors", [])))[:20]:
            print(f"benchmark: failed {line}", file=sys.stderr)
        cell.free()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        values = cell.check()
        control_values = cell.control(control) if control else None
    # a number the cell's limits leave out has no upper reading: not compared
    checks = {name: {"value": values[name], "limit": lim["limit"]} for name, lim in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": spec["chips"] if cuda else 0,
                   "memory_peak_bytes": max(setup_peak, peak) if cuda else 0,
                   "power_limit": power_limit() if cuda else "none"}
    if args.trace:
        device_info.update(busy_s=busy, window_s=ctx.trace.window_s)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control_values is not None:
        result["control"] = control_values
    result["checks"] = checks
    return result


class Context:
    """What a per-layer reader reads: the cell, the traced window's spans,
    units and work, the profiled window's trace, the program's calls
    (`profiled`), the reference's forwards of the work it completed
    (`model_work`) and launches, the kernel families' work models and the
    peaks."""

    def __init__(self, reg, cell, name, units, work, elapsed):
        self.reg, self.cell, self.name = reg, cell, name
        self.units, self.work, self.elapsed = units, work, elapsed
        self.span_s = dict(cell.spans.seconds)
        self.counters = cell.counters()
        self.peaks = reg.peaks()
        self.trace = self.profiled = self.model_work = self.launches = None

    def read_counters(self) -> dict:
        """Every family's launch counter (the op entry's `.launches`)."""
        import importlib

        out = {}
        for fam in self.families():
            f = self.reg.family(fam)
            for mod, attr in f.COUNTERS + getattr(f, "EXCLUSIVE", ()):
                out[f"{mod}:{attr}"] = getattr(importlib.import_module(mod), attr).launches
        return out

    def families(self) -> list[str]:
        names = [m["name"] for m in self.reg.metrics("per_layer", self.name)]
        return [n[: -len(".roofline")] for n in names if n.endswith(".roofline")]


def main(argv, started: float) -> int:
    """`started`: the epoch second the process started."""
    try:
        result = run(argv, started=started)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0
