"""Build and load the package's CUDA kernels.

The sources under `beat_this_tpu_torch/csrc/` are compiled with `nvcc` for
Hopper (`sm_90a`) into one shared library with a plain C interface, loaded
with `ctypes`. The library is built at first use, from the checkout's
sources only, into `build/kernels-<hash>/` beside the package (or under
`$BEAT_THIS_TORCH_BUILD`), where the hash covers the sources and the
compiler flags; a later process with the same sources loads it without
compiling. A failed build raises: nothing falls back to the plain PyTorch
versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libbeat_this_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# dropout arguments of the training entry points (ops/dropout.kernel_args,
# then the global batch bases item0 and row0 of ops/dropout.base_args)
_DROP = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, _I,
         ctypes.c_uint32, ctypes.c_uint32]
# C entry points: name -> argtypes (all return a cudaError_t as int)
_SIGNATURES = {
    "bt_fused_ff": [_I, _I] + [_P] * 8 + [_L, _L, _I, _P],
    "bt_fused_ff_scratch": [_I, _I, _L, _I, ctypes.POINTER(_L)],
    "bt_fused_time": [_I, _I] + [_P] * 15 + [_L, _I, _I, _I, _P],
    "bt_fused_time_scratch": [_I, _I, _L, _I, ctypes.POINTER(_L)],
    "bt_fused_freq": [_I, _I] + [_P] * 14 + [_L, _I, _I, _P],
    "bt_fused_freq_blocks": [_I, _I, ctypes.POINTER(_I)],
    "bt_ff_train_fwd": [_I, _I] + [_P] * 8 + [_L, _L, _I] + _DROP + [_P],
    "bt_ff_train_fwd_scratch": [_I, _I, _L, _I, ctypes.POINTER(_L)],
    "bt_ff_train_bwd": [_I, _I, _I] + [_P] * 13 + [_L, _L, _I, _L] + _DROP + [_P],
    "bt_ff_train_bwd_scratch": [_I, _I, _L, _I, _L, ctypes.POINTER(_L)],
    "bt_ff_wgrad_tiles": [_I, _I, ctypes.POINTER(_I)],
    "bt_attn_train_fwd": [_I, _I] + [_P] * 17 + [_L, _I, _I] + _DROP + [_P],
    "bt_attn_train_fwd_scratch": [_I, _I, _L, ctypes.POINTER(_L)],
    "bt_attn_train_bwd": [_I, _I] + [_P] * 21 + [_L, _I, _I, _L] + _DROP + [_P],
    "bt_attn_train_bwd_scratch": [_I, _I, _L, _L, ctypes.POINTER(_L)],
    "bt_attn_wgrad_tiles": [_I, ctypes.POINTER(_I)],
    "bt_freq_train_fwd": [_I, _I] + [_P] * 14 + [_L, _I, _I] + _DROP + [_P],
    "bt_freq_train_bwd": [_I, _I] + [_P] * 25 + [_L, _L, _I, _I, _L, _L] + _DROP + [_P],
    "bt_freq_train_bwd_scratch": [_I, _I, _L, _I, _L, _L, ctypes.POINTER(_L)],
    "bt_freq_wgrad_tiles": [_I, ctypes.POINTER(_I)],
    "bt_flash_fwd": [_I, _I] + [_P] * 7 + [_I, _I, _I] + _DROP + [_P, _P],
    "bt_flash_bwd": [_I, _I] + [_P] * 11 + [_I, _I, _I] + _DROP + [_P, _P],
    "bt_small_attn_fwd": [_I, _I, _I] + [_P] * 6 + [_L, _I] + _DROP + [_P],
    "bt_small_attn_bwd": [_I, _I, _I] + [_P] * 9 + [_L, _I] + _DROP + [_P],
    # the ablation kernels of beat_this_tpu_torch/bench/
    "bt_flash_ablate": [_I, _I, _I] + [_P] * 7 + [_I, _I, ctypes.c_float, _P, _P],
    "bt_freq_ablate": [_I, _I, _I] + [_P] * 14 + [_L, _I, _I, _P],
    "bt_freq_ablate_blocks": [_I, _I, _I, ctypes.POINTER(_I)],
    "bt_attn_variant": [_I, _I] + [_P] * 5 + [_I, _I, _I, _P],
    "bt_softmax_pass": [_I, _P, _P, _L, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_root() -> Path:
    env = os.environ.get("BEAT_THIS_TORCH_BUILD")
    return Path(env) if env else CSRC.parent.parent / "build"


def source_hash() -> str:
    """Hash of the compiler flags and every .cu / .cuh source."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise with every failure's output."""
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        procs = list(pool.map(
            lambda cmd: subprocess.run(cmd, capture_output=True, text=True), cmds
        ))
    failed = [
        f"{' '.join(cmd)}:\n{p.stdout}{p.stderr}"
        for cmd, p in zip(cmds, procs) if p.returncode != 0
    ]
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return "".join(p.stdout + p.stderr for p in procs)


def build() -> Path:
    """Compile the kernels unless a library for these sources exists; return
    its path. Each .cu file compiles in its own nvcc process, in parallel."""
    out_dir = build_root() / f"kernels-{source_hash()}"
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cus = sorted(CSRC.glob("*.cu"))
        objs = [Path(tmp) / (cu.stem + ".o") for cu in cus]
        log = _run([
            [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
            for cu, obj in zip(cus, objs)
        ])
        staged = Path(tmp) / LIB_NAME
        _run([[nvcc, "-shared", "-o", str(staged), *map(str, objs)]])
        (out_dir / "build.log").write_text(log)
        os.replace(staged, lib_path)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.bt_error_string.argtypes = [ctypes.c_int]
            lib.bt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = load_library().bt_error_string(err).decode()
        raise RuntimeError(f"{name} failed with CUDA error {err}: {text}")
