"""The directory mix (`harness/directory.py`): one `process_many` call a
pass, holding every file in the seeded order of that pass's groups, which
`process_many` cuts into the warmed groups again; the library mix's units
as they were; the two readers of the directory cells; and the comparison,
which passes a sound run and fails the control and each fault in both
directory cells, here at a CPU test's size with the cells' own limits."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from beat_this_tpu_torch import profiler
from conftest import tiny_registry
from harness import faults
from harness.directory import Directory
from harness.library import Library
from harness.main import run
from harness.registry import Registry
from harness.trace import Trace
from reference.mel import num_frames
from test_bench_program_spans import ev, session_of

SEED = 2**32 + 29
GROUPS = [[5, 0], [3, 6], [1, 4], [2]]  # group_files 2; the last group short
DIRECTORY = {"files": 5, "group_files": 2,
             "durations": {"dist": "loguniform", "min_s": 4.2, "max_s": 5.5}}
CELLS = {"final.library_dir_f32": "tf32", "small.library_bf16": "fp8"}


def pass_orders(seed, passes, n_groups=len(GROUPS)):
    """The order of the groups in each pass, as the seed draws it."""
    rng = np.random.default_rng(np.random.SeedSequence(seed).generate_state(4, np.uint64)[2])
    return [rng.permutation(n_groups).tolist() for _ in range(passes)]


def units(kind, passes, tmp_path):
    """The file lists that `passes` passes of `kind`'s units hand to
    `process_many`."""
    cell = kind({}, {"precision": "float32", "group_files": 2}, SEED, "cpu", tmp_path)
    cell.groups = GROUPS
    calls = []
    cell._group = lambda files: calls.append(list(files)) or 1.0
    for _ in range(passes * (len(GROUPS) if kind is Library else 1)):
        cell.unit()
    return calls


def test_the_library_mix_hands_over_one_group_a_unit_as_before(tmp_path):
    want = [GROUPS[j] for order in pass_orders(SEED, 3) for j in order]
    assert units(Library, 3, tmp_path) == want


def test_a_directory_unit_is_one_call_over_a_pass_in_the_seeded_group_order(tmp_path):
    calls = units(Directory, 3, tmp_path)
    assert len(calls) == 3
    for files, order in zip(calls, pass_orders(SEED, 3)):
        order = [j for j in order if j != 3] + [3]  # the short group last
        assert files == [i for j in order for i in GROUPS[j]]
        assert sorted(files) == list(range(7))


@pytest.fixture
def directory_registry(tmp_path):
    import torch

    torch.set_num_threads(2)
    return tiny_registry(tmp_path, {"directory_f32": DIRECTORY, "directory_bf16": DIRECTORY})


def test_process_many_forms_the_warmed_groups_in_order(directory_registry, tmp_path):
    from harness import audio
    from harness.main import build

    cell = build(directory_registry, "final.library_dir_f32", SEED, "cpu", tmp_path / "run",
                 False)
    cell.setup()
    cell.prime()
    calls, groups = [], []
    process_many, decode = cell.f2f.process_many, cell.f2f._decode_group
    cell.f2f.process_many = lambda tasks, **kw: calls.append(len(tasks)) or process_many(
        tasks, **kw)
    cell.f2f._decode_group = lambda signals: groups.append(
        tuple(num_frames(len(s)) for s in signals)) or decode(signals)
    durs = audio.durations(DIRECTORY["durations"], DIRECTORY["files"])
    seconds = sum(int(d * audio.SR) for d in durs) / audio.SR
    cell.window_started()
    assert [cell.unit() for _ in range(2)] == pytest.approx([seconds, seconds])
    assert calls == [5, 5]
    warmed = [tuple(cell.frames[i] for i in g) for g in cell.groups]
    assert [len(g) for g in cell.groups] == [2, 2, 1]
    want = [warmed[j] for order in pass_orders(SEED, 2, 3)
            for j in sorted(order, key=lambda j: j == 2)]  # the short group closes a call
    assert groups == want
    assert cell.attempted == 10 and sum(len(a) for a in cell.answers.values()) == 10
    cell.free()


# one call, 1000-9000 us on the trace; the program's spans read LAG_US
# later than the trace's clock; four group spans; two loads overlap
# (1100-1900 and 1500-2400, merged 1100-2400), two more at 4100-4600 and
# 6100-6900; the card busy at 1200-1400, 2000-3900, 4300-4400, 6000-8800.
# Aligned, the loads move LAG_US earlier: 1060-2360 holds 200 + 360 us of
# busy time, 4060-4560 100, 6060-6860 is busy throughout
LAG_US = 40.0
CALL = [("group", 1000 + LAG_US, 3950, 200.0), ("load", 1100, 1900, None),
        ("load", 1500, 2400, None),
        ("group", 4000 + LAG_US, 5950, 300.0), ("load", 4100, 4600, None),
        ("group", 6000 + LAG_US, 7950, 250.0), ("load", 6100, 6900, None),
        ("group", 8000 + LAG_US, 8950, 250.0)]
IDLE_IN_LOAD_US = (1300 - 200 - 360) + (500 - 100) + 0


def call_trace():
    return Trace([ev("user_annotation", "bench.window", 0, 10000),
                  ev("user_annotation", "bench.call", 1000, 8000),
                  ev("user_annotation", "bench.decode_group", 1500, 2000),
                  ev("kernel", "k", 1200, 200), ev("gpu_memcpy", "HtoD", 2000, 1900),
                  ev("kernel", "k", 4300, 100), ev("kernel", "k", 6000, 2800)])


def ctx(kind, trace=None, span_s=None, work=0.0):
    return SimpleNamespace(cell=SimpleNamespace(work_name=kind), trace=trace,
                           span_s=span_s or {}, work=work)


@pytest.fixture
def with_session(monkeypatch):
    def use(session):
        monkeypatch.setitem(profiler._state, "session", session)
    return use


def test_idle_under_merged_loads_aligned_by_each_calls_first_group(with_session):
    with_session(session_of(CALL))
    read = Registry().reader("device.idle_in_load.dir").read
    trace = call_trace()
    # Unix time in us, as a float, resolves 0.25 us: 1 us of the window is 0.01
    assert read(ctx("audio_s", trace)) == pytest.approx(100.0 * IDLE_IN_LOAD_US / 10000,
                                                        abs=0.01)
    assert read(ctx("frames", trace)) is None
    with_session(None)
    assert read(ctx("audio_s", trace)) is None


@pytest.mark.parametrize("spans,match", [
    ([(n, a + (3000 if i == 7 else 0), b + (3000 if i == 7 else 0), s)
      for i, (n, a, b, s) in enumerate(CALL)], "starts in no call range"),
    ([(n, a, b + (1500 if i == 7 else 0), s) for i, (n, a, b, s) in enumerate(CALL)],
     "lies outside its call's harness range"),
    ([s for s in CALL if s[0] != "group"], "0 program group spans"),
])
def test_a_group_span_off_its_call_fails_by_name(with_session, spans, match):
    with_session(session_of(spans))
    with pytest.raises(RuntimeError, match=f"device.idle_in_load.dir: .*{match}"):
        Registry().reader("device.idle_in_load.dir").read(ctx("audio_s", call_trace()))


def test_exposed_io_is_the_call_less_its_decode_groups():
    read = Registry().reader("infer.exposed_io_ms_per_ks").read
    got = read(ctx("audio_s", span_s={"call": 2.5, "decode_group": 1.75, "group": 9.0},
                   work=5000.0))
    assert got == pytest.approx(1e3 * (2.5 - 1.75) / 5.0)  # 150 ms per 1000 s
    assert read(ctx("audio_s", span_s={"group": 2.5, "decode_group": 1.75}, work=5000.0)) is None
    assert read(ctx("frames", span_s={"call": 2.5, "decode_group": 1.0}, work=5.0)) is None


def cell_run(reg, name, **kw):
    argv = ["--workload", name, "--seed", str(SEED), "--seconds", "0.3"]
    return run(argv, started=time.time(), device="cpu", reg=reg, **kw)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_directory_cells_sound_control_and_faults(directory_registry, name):
    sound = cell_run(directory_registry, name, control=CELLS[name])
    assert sound["correct"], sound["checks"]
    assert sound["control"]["logit_gap"] > sound["checks"]["logit_gap"]["limit"]
    for fault in faults.LIBRARY:
        bad = cell_run(directory_registry, name, patch=lambda c, f=fault: faults.plant(c, f))
        assert not bad["correct"], (fault, bad["checks"])
