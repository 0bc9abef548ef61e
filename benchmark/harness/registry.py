"""What a cell is made of, found by name: BENCHMARK.json at the checkout's
root names the cells, configurations and metrics; each configuration is
its file, each traffic mix `traffic/<name>.json`, each cell's comparison
limits `limits/<cell>.json`, each per-layer metric's reader
`metrics/<name>.py` and each kernel family's names and work model
`work/<family>.py`. A new cell, configuration, mix, metric or family is a
new file and a new entry: no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = HERE.parent  # the checkout


class Registry:
    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root, self.here = root, here
        self.bench = json.loads((root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.here / "limits" / f"{cell}.json").read_text())

    def metrics(self, group: str, cell: str) -> list[dict]:
        """The `end_to_end` or `per_layer` metrics that cell `cell` reports."""
        return [m for m in self.bench[group] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return load_module(self.here / "metrics" / f"{metric}.py")

    def family(self, name: str):
        return load_module(self.here / "work" / f"{name}.py")

    def peaks(self) -> dict:
        return json.loads((self.here / "work" / "peaks.json").read_text())


def load_module(path: Path):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = f"bench_{path.parent.name}_{path.stem}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
