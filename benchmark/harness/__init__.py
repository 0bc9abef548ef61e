"""The benchmark harness: cells found by name from BENCHMARK.json, the
inputs made from the seed, the measured window, the traced run's readings
and the comparison with the reference that decides `correct`."""
