"""The entry point prints no result without a card or without the
program beside it; on the card (marked `gpu`) a short run is correct."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import HERE

ROOT = HERE.parent


def run_py(cwd, *args, timeout=900):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "final.library_f32",
                           "--seed", str(2**31 + 3), "--seconds", "2", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = run_py(tmp_path)
    assert out.returncode != 0 and '"correct"' not in out.stdout


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run_py(ROOT, timeout=1500)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
