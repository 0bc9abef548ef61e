"""The PyTorch package (and chip_smoke.py) imports no JAX and nothing of the
JAX package `beat_this_tpu`, computes no kernel product with a library's
fused operator, and builds its kernels only when they are launched; a build
without nvcc raises instead of falling back."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from beat_this_tpu_torch.model.layers import FeedForward
from beat_this_tpu_torch.ops import _build
from beat_this_tpu_torch.ops.fused_ff import fused_ff

PACKAGE = Path(__file__).resolve().parent.parent / "beat_this_tpu_torch"


def test_import_pulls_in_no_jax():
    """Every module of the port (the bench entry points, the DBN decoder,
    the hub module, the launch-script drivers, the kernel gate and the
    data-parallel package among them), imported in a
    fresh interpreter, loads no module named jax*, beat_this_tpu,
    beat_this_tpu.*, tools or tools.*."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import beat_this_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) > 30, names\n"
        "for mod in ('ops.flash_attention', 'ops.small_attention', 'bench.fused_freq_ablate',\n"
        "            'bench.flash_ablate', 'bench.softmax_variants', 'postprocessing.dbn', 'hub',\n"
        "            'ops.stretch', 'profiler', 'clean_checkpoints', 'preprocess_audio',\n"
        "            'overfit_smoke', 'compute_paper_metrics', 'check_all', 'bench.mel_stage',\n"
        "            'bench.cli_dir', 'bench.dbn', 'bench.eval_protocol', 'bench.small',\n"
        "            'parallel', 'parallel.mesh', 'parallel.distributed'):\n"
        "    assert 'beat_this_tpu_torch.' + mod in names, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'beat_this_tpu', 'tools')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'beat_this_tpu.', 'tools.')))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=PACKAGE.parent,
    )
    assert proc.returncode == 0, proc.stderr


def test_sources_import_nothing_of_the_jax_package():
    """No `import beat_this_tpu` or `from beat_this_tpu.` (nor of jax, nor of
    the JAX package's `tools/`) in the port's sources or chip_smoke.py, at
    any indentation."""
    pattern = re.compile(r"^\s*(import (beat_this_tpu|jax|tools)\b|from (beat_this_tpu|jax|tools)"
                         r"(\.| import))", re.MULTILINE)
    paths = list(PACKAGE.rglob("*.py")) + [PACKAGE.parent / "chip_smoke.py"]
    assert len(paths) > 30
    for name in ("ops/flash_attention.py", "ops/small_attention.py", "bench/flash_ablate.py",
                 "bench/fused_freq_ablate.py", "bench/softmax_variants.py", "postprocessing/dbn.py",
                 "hub.py", "ops/stretch.py", "profiler.py", "clean_checkpoints.py",
                 "preprocess_audio.py", "overfit_smoke.py", "compute_paper_metrics.py",
                 "check_all.py", "bench/mel_stage.py", "bench/cli_dir.py", "bench/dbn.py",
                 "bench/eval_protocol.py", "bench/small.py", "parallel/__init__.py",
                 "parallel/mesh.py", "parallel/distributed.py"):
        assert PACKAGE / name in paths
    for path in paths:
        assert not pattern.search(path.read_text()), path


def test_sources_use_no_library_kernels():
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path
        assert not re.search(r"^(import|from) triton", text, re.MULTILINE), path
        assert not re.search(r"^(import|from) jax", text, re.MULTILINE), path


def test_kernel_sources_exist():
    names = {p.name for p in (PACKAGE / "csrc").glob("*.cu")}
    assert names == {"fused_ff.cu", "fused_time.cu", "fused_freq.cu", "fused_ff_train.cu",
                     "fused_time_train.cu", "fused_freq_train.cu", "flash_attention.cu",
                     "small_attention.cu", "freq_ablate.cu", "softmax_variants.cu",
                     "softmax_passes.cu", "freq_core.cu"}


def test_attention_wrappers_call_no_library_product():
    """The modules of the attention kernels take no matrix product of a
    library on a CUDA path: `torch.matmul` stands only in their plain
    versions (`*_ref`, `_ref_chunk`), no `bmm`, `einsum` or `F.` call
    anywhere."""
    for name in ("flash_attention.py", "small_attention.py"):
        text = (PACKAGE / "ops" / name).read_text()
        assert not re.search(r"\bbmm\b|einsum|torch\.nn\.functional|\bF\.", text), name
        for block in re.split(r"^(?=def |class )", text, flags=re.MULTILINE):
            if "torch.matmul" in block:
                assert re.match(r"def (\w+_ref|_ref_chunk)\(", block), (name, block[:60])


@pytest.mark.parametrize("name", ["fused_freq_ablate.py", "flash_ablate.py",
                                  "softmax_variants.py"])
def test_bench_wrappers_call_no_library_product(name):
    """In the bench modules a product, a softmax pass or any `F.` call of a
    library stands only in the plain versions (`*_ref`, `_ref_chunk`): the
    wrappers' CUDA paths reach nothing but the C entry points."""
    text = (PACKAGE / "bench" / name).read_text()
    assert "bt_" in text and "_build.load_library()" in text
    for block in re.split(r"^(?=def |class )", text, flags=re.MULTILINE):
        if re.search(r"torch\.matmul|\bbmm\b|einsum|\bF\.|torch\.exp2|torch\.softmax|\.amax\(", block):
            assert re.match(r"def (\w+_ref|_ref_chunk)\(", block), (name, block[:60])


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("BEAT_THIS_TORCH_BUILD", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_wrapper_rejects_other_devices():
    ff = FeedForward(32).to("meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_ff(torch.empty((4, 32), device="meta"), ff)
