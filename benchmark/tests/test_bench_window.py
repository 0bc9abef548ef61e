"""The whole-unit rate: all the work completed over the time from the
window's start to the end of the last unit, stalls included."""

import time

from harness.main import window


class Units:
    spans = None

    def __init__(self, seconds, stall_at=None, stall=0.0):
        self.seconds, self.stall_at, self.stall, self.done = seconds, stall_at, stall, 0

    def window_started(self):
        self.done = 0

    def unit(self):
        time.sleep(self.seconds + (self.stall if self.done == self.stall_at else 0.0))
        self.done += 1
        return 10.0


def test_the_window_runs_whole_units_past_its_length():
    units, work, elapsed = window(Units(0.03), 0.1)
    assert units == 4 and work == 40.0  # the unit that crosses 0.1 s completes
    assert 0.12 <= elapsed < 0.2
    assert abs(work / elapsed - 10.0 / 0.03) / (10.0 / 0.03) < 0.2


def test_a_stall_in_the_window_lowers_the_rate():
    units, work, elapsed = window(Units(0.02), 0.2)
    steady = work / elapsed
    units, work, elapsed = window(Units(0.02, stall_at=2, stall=0.1), 0.2)
    assert elapsed >= 0.2
    assert work / elapsed < 0.75 * steady
    assert work == 10.0 * units
