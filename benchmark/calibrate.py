"""Readings for the limits of a cell's comparison, in one process:

    python3 benchmark/calibrate.py --workload final.train_bf16 --seconds 2 \\
        --seeds 101 102 103 --control fp8 --control-seeds 3 \\
        --faults half unchanged --fault-seeds 3

For each seed, a run of the cell (a short window at the cell's own load)
and its compared numbers: the lower readings. On the first
`--control-seeds` seeds also the control's (the reference computed in
`--control` precision in the program's place), and on the first
`--fault-seeds` seeds a run with each fault of `harness/faults.py`
planted: the upper readings. One JSON line per reading, then the largest
sound reading and the smallest control and fault reading of each number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None):
    from harness import faults
    from harness.main import run

    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", choices=("tf32", "fp8"))
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--out", type=Path)
    a = p.parse_args(argv)
    rows = []

    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if a.out:
            with a.out.open("a") as f:
                f.write(line + "\n")

    args = lambda s: ["--workload", a.workload, "--seed", str(s), "--seconds", str(a.seconds)]
    for i, seed in enumerate(a.seeds):
        ctl = a.control if a.control and i < a.control_seeds else None
        r = run(args(seed), started=time.time(), control=ctl)
        emit({"seed": seed, "reading": "program", **{k: v["value"] for k, v in r["checks"].items()}})
        if ctl:
            emit({"seed": seed, "reading": f"control {ctl}", **r["control"]})
        if i < a.fault_seeds:
            for fault in a.faults:
                r = run(args(seed), started=time.time(),
                        patch=lambda cell, f=fault: faults.plant(cell, f))
                emit({"seed": seed, "reading": f"fault {fault}",
                      **{k: v["value"] for k, v in r["checks"].items()}})
    summary = {}
    for row in rows:
        for k, v in row.items():
            if k in ("seed", "reading"):
                continue
            key = (row["reading"], k)
            agg = max if row["reading"] == "program" else min
            summary[key] = agg(summary.get(key, v), v)
    for (reading, k), v in sorted(summary.items()):
        print(f"{'largest' if reading == 'program' else 'smallest'} {reading} {k}: {v!r}")


if __name__ == "__main__":
    main()
