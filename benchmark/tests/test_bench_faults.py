"""The comparison decides `correct`: a sound run passes, the control (the
reference in the next lower precision in the program's place) and each
fault planted in the timed path fail, here at a CPU test's size with the
cells' own limits."""

import time

import pytest

from harness import faults
from harness.main import run


def cell_run(reg, name, **kw):
    argv = ["--workload", name, "--seed", str(2**32 + 17), "--seconds", "0.3"]
    return run(argv, started=time.time(), device="cpu", reg=reg, **kw)


def test_library_sound_control_and_faults(library_registry):
    reg = library_registry
    sound = cell_run(reg, "final.library_f32", control="tf32")
    assert sound["correct"], sound["checks"]
    assert sound["control"]["logit_gap"] > sound["checks"]["logit_gap"]["limit"]
    for fault in faults.LIBRARY:
        bad = cell_run(reg, "final.library_f32", patch=lambda c, f=fault: faults.plant(c, f))
        assert not bad["correct"], (fault, bad["checks"])


def test_loops_control_fails(library_registry):
    r = cell_run(library_registry, "final.loops_bf16", control="fp8")
    assert r["correct"], r["checks"]
    assert r["control"]["logit_gap"] > r["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_training_faults_fail(train_registry, fault):
    bad = cell_run(train_registry, "final.train_bf16", patch=lambda c: faults.plant(c, fault))
    assert not bad["correct"], bad["checks"]


def test_training_sound_and_control(train_registry):
    r = cell_run(train_registry, "final.train_bf16", control="fp8")
    assert r["correct"], r["checks"]
    assert any(r["control"][k] > c["limit"] for k, c in r["checks"].items()), r["control"]
