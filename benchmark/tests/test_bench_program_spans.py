"""The readers of the program's own spans and counters
(`beat_this_tpu_torch/profiler.py`) on a synthetic session and trace: the
span sums per 1000 s of audio, the padding share, the host time per step,
the card's idle time under `load` spans once the session is aligned to the
trace by the `group` anchors, None where the program records no session
or the cell is of the other kind, and a failure by name where the session
cannot be read or aligned."""

from types import SimpleNamespace

import pytest

from beat_this_tpu_torch import profiler
from harness.registry import Registry
from harness.trace import Trace

UNIX_NS = 1_790_000_000_000_000_000  # the session's clock (Unix ns) at the trace's 0
LAG_US = 40.0  # the harness's group range opens this long before the program's span
NEW = ("infer.load_ms_per_ks", "infer.write_ms_per_ks", "infer.wait_ms_per_ks",
       "infer.pad_share", "device.idle_in_load.infer", "train.host_ms")


def reader(name):
    return Registry().reader(name)


def session_of(spans, counters=None):
    """A session whose spans are (name, start us, end us on the trace's
    clock, audio_s or None)."""
    s = profiler.Session()
    s.counters = dict(counters or profiler.counters)
    for name, a, b, audio_s in spans:
        sp = profiler.Span(name)
        sp.start_ns, sp.end_ns = UNIX_NS + round(a * 1e3), UNIX_NS + round(b * 1e3)
        sp.audio_s = audio_s
        s.spans.append(sp)
    return s


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# two units: harness ranges 1000-4000 and 5000-9000 us; the program's group
# spans open LAG_US later; loads of 1000 and 2000 us; the card busy at
# 1500-1700 (inside the first load), 2500-3800, 5200-5600 (inside the
# second load) and 7500-8500
GROUPS = [("group", 1000 + LAG_US, 3990, 300.0),
          ("load", 1050, 2050, None),
          ("wait", 2600, 2700, None),
          ("write", 3900, 3950, None),
          ("group", 5000 + LAG_US, 8990, 500.0),
          ("load", 5050, 7050, None),
          ("wait", 7600, 7900, None),
          ("write", 8900, 8950, None)]
IDLE_IN_LOAD_US = (1000 - 200) + (2000 - 400)


def library_trace():
    return Trace([ev("user_annotation", "bench.window", 0, 10000),
                  ev("user_annotation", "bench.group", 1000, 3000),
                  ev("user_annotation", "bench.group", 5000, 4000),
                  ev("kernel", "k", 1500, 200), ev("gpu_memcpy", "HtoD", 2500, 1300),
                  ev("kernel", "k", 5200, 400), ev("kernel", "k", 7500, 1000)])


@pytest.fixture
def with_session(monkeypatch):
    def use(session):
        monkeypatch.setitem(profiler._state, "session", session)
    return use


def ctx(kind, trace=None):
    return SimpleNamespace(cell=SimpleNamespace(work_name=kind), trace=trace)


def test_each_new_metric_has_a_reader_and_its_cells():
    reg = Registry()
    per_layer = {m["name"]: m for m in reg.bench["per_layer"]}
    for name in NEW:
        assert callable(reg.reader(name).read)
        cells = per_layer[name]["workloads"]
        kinds = {"train"} if name.startswith("train.") else {"library", "directory"}
        assert cells and all(reg.traffic(reg.cell(c)["traffic"])["kind"] in kinds for c in cells)


@pytest.mark.parametrize("name,span_us", [
    ("infer.load_ms_per_ks", 1000 + 2000),
    ("infer.write_ms_per_ks", 50 + 50),
    ("infer.wait_ms_per_ks", 100 + 300),
])
def test_span_sums_per_1000_s_of_audio(with_session, name, span_us):
    with_session(session_of(GROUPS))
    got = reader(name).read(ctx("audio_s"))
    assert got == pytest.approx(1e6 * (span_us / 1e6) / 800.0)
    assert reader(name).read(ctx("frames")) is None


def test_pad_share_reads_the_counters_since_the_session_began(with_session, monkeypatch):
    monkeypatch.setattr(profiler, "counters",
                        {"forward_frames": 2 * 32 * 768 + 1000, "masked_frames": 2 * 32 * 255 + 7})
    with_session(session_of(GROUPS, {"forward_frames": 1000, "masked_frames": 7}))
    assert reader("infer.pad_share").read(ctx("audio_s")) == pytest.approx(100 * 255 / 768)
    with_session(session_of(GROUPS, profiler.counters))
    with pytest.raises(RuntimeError, match="infer.pad_share"):
        reader("infer.pad_share").read(ctx("audio_s"))


def test_host_time_per_step(with_session):
    with_session(session_of([("step", 0, 500e3, None), ("micro", 10, 200e3, None),
                             ("step", 600e3, 1300e3, None)]))
    assert reader("train.host_ms").read(ctx("frames")) == pytest.approx(600.0)
    assert reader("train.host_ms").read(ctx("audio_s")) is None
    with_session(session_of([("micro", 0, 5, None)]))
    with pytest.raises(RuntimeError, match="train.host_ms"):
        reader("train.host_ms").read(ctx("frames"))


def test_idle_under_load_aligned_by_the_group_anchors(with_session):
    with_session(session_of(GROUPS))
    trace = library_trace()
    got = reader("device.idle_in_load.infer").read(ctx("audio_s", trace))
    # the offset takes LAG_US with it: each load reads LAG_US early on the
    # trace, which moves no busy interval's edge in or out of it here
    assert got == pytest.approx(100.0 * IDLE_IN_LOAD_US / 10000)
    assert got <= 100.0 * (1.0 - trace.busy_s / trace.window_s)


@pytest.mark.parametrize("shift_us,match", [
    (5000.0, "outside its unit's harness range"),
    (None, "2 harness group ranges against 1 program group spans"),
])
def test_an_unaligned_session_fails_by_name(with_session, shift_us, match):
    spans = list(GROUPS)
    if shift_us is None:
        spans = spans[:4]
    else:  # the second unit's span drifts off its harness range
        name, a, b, audio_s = spans[4]
        spans[4] = (name, a + shift_us, b + shift_us, audio_s)
    with_session(session_of(spans))
    with pytest.raises(RuntimeError, match=f"device.idle_in_load.infer: .*{match}"):
        reader("device.idle_in_load.infer").read(ctx("audio_s", library_trace()))


@pytest.mark.parametrize("name", NEW)
def test_no_session_reads_nothing(with_session, monkeypatch, name):
    kind = "frames" if name.startswith("train.") else "audio_s"
    with_session(None)
    assert reader(name).read(ctx(kind, library_trace())) is None
    monkeypatch.delattr(profiler, "session")  # a program without its own spans
    assert reader(name).read(ctx(kind, library_trace())) is None


@pytest.mark.parametrize("name", NEW[:3])
def test_a_session_without_groups_fails_by_name(with_session, name):
    with_session(session_of([("load", 0, 5, None)]))
    with pytest.raises(RuntimeError, match=name):
        reader(name).read(ctx("audio_s"))
