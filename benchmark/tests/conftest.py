"""CPU tests of the benchmark (`python -m pytest benchmark/tests -q`); the
repository's own test run does not collect them. A test marked `gpu`
needs the card and decides inside the test."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

TINY = {"transformer_dim": 64, "n_layers": 1}


def tiny_registry(root: Path, traffic: dict | None = None):
    """A copy of the benchmark under `root` whose configurations are cut to
    a CPU test's size (widths 32-128 in the frontend, 64 in one main layer)
    and whose mixes are those of `traffic` (name -> changed keys)."""
    from harness.registry import Registry

    here = root / "benchmark"
    for d in ("metrics", "work", "traffic", "limits", "configs"):
        shutil.copytree(HERE / d, here / d)
    shutil.copy(HERE.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    for f in (here / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update(TINY)
        f.write_text(json.dumps(cfg))
    for name, changes in (traffic or {}).items():
        f = here / "traffic" / f"{name}.json"
        f.write_text(json.dumps({**json.loads(f.read_text()), **changes}))
    return Registry(root=root, here=here)


SHORT_LIBRARY = {"files": 3, "group_files": 2,
                 "durations": {"dist": "loguniform", "min_s": 4.2, "max_s": 5.5}}
SHORT_TRAIN = {"micro_batches": 2, "crops": 2, "frames": 512,
               "corpus": {"pieces": 3, "frames": 1100}}


@pytest.fixture
def library_registry(tmp_path):
    import torch

    torch.set_num_threads(2)
    return tiny_registry(tmp_path, {"library_f32": SHORT_LIBRARY, "loops_bf16": SHORT_LIBRARY})


@pytest.fixture
def train_registry(tmp_path):
    import torch

    torch.set_num_threads(2)
    return tiny_registry(tmp_path, {"train_bf16": SHORT_TRAIN})
