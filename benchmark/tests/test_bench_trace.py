"""The trace's reduction: busy time as the union of device intervals, idle
gaps by the innermost harness range open, and a window with no device
event fails by name."""

import pytest

from harness.trace import Trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_union_idle_gaps_and_kernel_time():
    t = Trace([ev("user_annotation", "bench.window", 0, 1000),
               ev("user_annotation", "bench.group", 0, 600),
               ev("user_annotation", "bench.forward", 100, 300),
               ev("kernel", "k2_attn", 150, 60), ev("kernel", "k2_attn", 200, 20),
               ev("kernel", "k3", 250, 50),
               ev("gpu_memcpy", "Memcpy HtoD", 700, 100), ev("kernel", "later", 2000, 5)])
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(70e-6 + 50e-6 + 100e-6)  # 150-220, 250-300, 700-800
    assert t.kernel_seconds([r"k2_"]) == pytest.approx(80e-6)
    assert t.kernel_count(r"k2_attn") == 2
    # each gap goes to the innermost range open at its middle
    gaps = dict(t.idle_gaps())
    assert gaps["forward"] == pytest.approx(30e-6)  # 220-250
    assert gaps["group"] == pytest.approx(150e-6 + 400e-6)  # 0-150, 300-700
    assert gaps["outside spans"] == pytest.approx(200e-6)  # 800-1000


def test_a_window_with_no_device_event_fails_by_name():
    with pytest.raises(RuntimeError, match="no device event"):
        Trace([ev("user_annotation", "bench.window", 0, 1000),
               ev("kernel", "outside", 5000, 10)])
