"""Run one cell of the benchmark of beat_this_tpu_torch on the first CUDA card:

    python3 benchmark/run.py --workload final.library_f32 --seed 7 --seconds 10 --trace 0

from the root of a checkout. The cells, metrics and bounds are in
BENCHMARK.json; the last line of standard output is the run's result as JSON.
"""

import os
import sys
import time
from pathlib import Path


def process_started() -> float:
    """The epoch second this process started (its set-up counts from
    there), from /proc; the current time where /proc cannot tell."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat[stat.rindex(")") + 2 :].split()[19])
        boot = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


if __name__ == "__main__":
    STARTED = process_started()
    HERE = Path(__file__).resolve().parent
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    from harness.main import main

    sys.exit(main(sys.argv[1:], STARTED))
