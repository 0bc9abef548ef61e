"""The PyTorch package imports no JAX, computes no kernel product with a
library's fused operator, and builds its kernels only when they are
launched; a build without nvcc raises instead of falling back."""

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
    code = (
        "import sys\n"
        "import beat_this_tpu_torch, beat_this_tpu_torch.inference, beat_this_tpu_torch.cli\n"
        "import beat_this_tpu_torch.ops.fused_ff, beat_this_tpu_torch.ops.fused_time\n"
        "import beat_this_tpu_torch.ops.fused_freq, beat_this_tpu_torch.io.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=PACKAGE.parent,
    )
    assert proc.returncode == 0, proc.stderr


def test_sources_use_no_library_kernels():
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path
        assert not re.search(r"^(import|from) triton", text, re.MULTILINE), path
        assert not re.search(r"^(import|from) jax", text, re.MULTILINE), path


def test_kernel_sources_exist():
    names = {p.name for p in (PACKAGE / "csrc").glob("*.cu")}
    assert names == {"fused_ff.cu", "fused_time.cu", "fused_freq.cu"}


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
