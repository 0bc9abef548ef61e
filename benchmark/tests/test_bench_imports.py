"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import subprocess
import sys

from conftest import HERE
from harness.main import forbidden_modules

FORBIDDEN = {"jax", "jaxlib", "flax", "beat_this_tpu"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for path in files:
        assert not set(imported(path)) & FORBIDDEN, path
    for path in (HERE / "reference").glob("*.py"):
        assert "beat_this_tpu_torch" not in set(imported(path)), path


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "beat_this_tpu_torch_fake.x", None)
    assert forbidden_modules() == [] or "beat_this_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "beat_this_tpu.model", None)
    assert "beat_this_tpu" in forbidden_modules()


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness.main, harness.library, "
            "harness.training, beat_this_tpu_torch.inference, beat_this_tpu_torch.train.task; "
            "print(harness.main.forbidden_modules())" % (str(HERE), str(HERE.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip() == "[]"
