#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (beat_this_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines and its seconds; any failure exits
non-zero without the final `"ok": true` line:

1. environment: GPU name and power limit, torch / CUDA / nvcc versions;
2. build: compiles the CUDA kernels from this checkout's sources, and
   checks with `cuobjdump -sass` that every instantiation of the flash
   kernels (forward, dq, dk/dv; float32 and bfloat16) and of the
   small-sequence kernels (forward, backward; F 1-32, D 16 and 32, float32
   and bfloat16; ptxas's registers and spills printed), and every one of the
   feed-forward kernels' products (training forward and backward, and the
   eval K1 and K2's tail), of the time-axis attention branch's kernels
   (the q/k/v product shared by the eval block K2 and the training forward,
   the attention core's forward at eval and in training, the out
   projections; backward d_go, dq, dk/dv and products), of the
   frequency block's kernel (K3, B6, and B13's qkv / ff / attn cuts; its
   copy and rms cuts hold none) and training backward, and of the 11
   softmax variants (B15a), bfloat16 and the float32 split products alike,
   holds tensor-core HMMA instructions (ptxas's registers and spills
   printed for B12, B13 and B15a);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the main paths' shapes, in float32 (TF32 off, relative max
   deviation <= 1e-3) and bfloat16 (< 2.5e-2), with median times and the
   least time the card could take (`bound`); the feed-forward and the
   attention branch's training backwards are timed by their device time
   (events around calls queued behind a spin kernel), as the host's
   launches weigh in. The six
   training kernels compare the output and every gradient, with the same
   seed on both sides: the attention branch and the feed-forward (forward
   and backward) at a main layer's shape (8 x 1500 x 512, 16 heads;
   dropout 0 and 0.2)
   and at the frontend's three time blocks (256/128/64 sequences of 1500
   frames, C 32/64/128; dropout 0.1), and the fused frequency block
   (forward and backward: output, dx and ten parameter gradients) at the
   frontend's three frequency blocks (12000 items of F 32/16/8, C
   32/64/128; dropout 0 and 0.1). The attention kernels of the head_dim 16
   configuration on (entries, seq, 16): flash_attention without lse and
   small_attention's forward at an eval batch of 3 chunks, flash_attention
   with lse and its backward and small_attention forward and backward
   (output, dq, dk, dv) at a training microbatch of 8 crops, flash_attention
   with lse and its backward also at head_dim 32 (512, 1536, 32),
   small_attention also at head_dim 32 (12000, 32, 32; small_attention timed
   by device time, its kernels taking microseconds); beside them
   the time of one `scaled_dot_product_attention` call on rotated q and k
   (a yardstick for the table, on no path). The eval kernels, the
   attention branch and the feed-forward also at C 256 and 384 (the widths
   `--transformer-dim` reaches), at small row counts. Then the ablation
   kernels of `beat_this_tpu_torch/bench/`: every stage of the frequency
   block, every mode of the flash forward, every softmax variant and pass,
   at the benches' full sizes in bfloat16 and float32 (the passes in
   float32 only), each against its plain version; the `full` stage
   bit-equal to the block's own kernel, and beside it the sum of its cuts
   (attn + ff - copy, by device time), each cut at `full`'s blocks per SM;
   then the three bench entry points
   through their `main()` at default flags, with exact launch counts;
4. end to end: the full-width BeatThisConfig() model from a numpy-seeded
   synthetic checkpoint runs the port's CLI in-process on a 75 s click
   track (three chunks) and a 12 s one (the short-piece path), in float32
   and with --float16. The checkpoint is random except for its input batch
   norm (the long piece's log-mel statistics) and its task head, fit by
   least squares on the plain float32 path's features to the long piece's
   clicks, so the logits peak at the clicks as a trained model's peak at
   beats. Checks: the .beats files parse, every kernel's launch counter
   went up, the logits agree with the plain path of the same dtype on the
   card within the phase-3 limits, and the beats agree with the float32
   plain path's at F >= 0.999. Then the same with a head_dim 16
   checkpoint ("h16": every time block through flash_attention, every
   frequency block through small_attention, every feed-forward through
   fused_ff), with exact launch counts per CLI run. On the stock
   checkpoint also `--dbn` on the 75 s piece (beats at F >= 0.999 against
   the minimal postprocessor's, and equal to the DBN decode of the plain
   float32 path's logits) and directory mode over four wavs of unequal
   length, byte-identical to the four single-file runs;
5. training end to end: `python -m beat_this_tpu_torch.train`, in-process,
   on a click corpus written by the port's `data.synth`, at full width
   (512 x 6, 16 heads), batch 8 x 1500 frames, 2 microbatches per step
   (reduced from 8), 3 steps: the stock configuration (partial
   transformers, frontend 32/64/128) in float32 and bfloat16, and
   --no-partial-transformers in float32 only (reduced). Checks: each
   training kernel launched exactly (layers + frontend blocks) x 2
   microbatches x 3 steps times (the frequency-block kernels 3 x 2 x 3),
   finite losses, the first step's losses, gradients and batch-norm
   statistics of the kernel path against the plain path on the same batch
   and seeds within the phase-3 limits (every gradient in float32; in
   bfloat16 every gradient under a max-pool-free loss and the
   kernel-produced layers' under the training loss (shift-tolerant), see
   `first_step_check`), the checkpoint loads through `load_model` and the
   port's CLI writes a .beats file with it. Prints the step time and the
   peak device memory. Then the h16 model through the `Trainer` class (the
   command line fixes head_dim 32), float32 and bfloat16, with the same
   checks; and one 2-step run of `--transformer-dim 256 --n-layers 2` in
   float32 (8 heads: the C 256 instantiations), with exact launch counts;
   in bfloat16 the first step prints the distance of
   `WATCHED_GRADS` (the gradient nearest its limit, ROADMAP C6) from the
   float32 plain path against the bfloat16 plain path's, over the limit or
   not;
6. the launch-script drivers, through their entry points' `main`:
   `preprocess_audio --stage all` over three raw click wavs (22.05 and
   44.1 kHz, 8-20 s) with one pitch and one tempo variant, its spectrograms
   (log-mel on the card) within float16 rounding of the port's CPU log-mel;
   `overfit_smoke`'s body (`overfit`) at full width, the stock model in
   float32 and bfloat16 and the head_dim 16 one in bfloat16, each on a fresh
   click corpus with 512-frame crops as the JAX script, for OVERFIT_EPOCHS
   epochs at OVERFIT_LR: each must reach mean F beat >= 0.95 and downbeat
   >= 0.90 on its training pieces through the hand-written training
   kernels, with exact launch counts for its training steps and its scoring;
   `clean_checkpoints` on the stock float32 run's checkpoint; and
   `compute_paper_metrics` on the cleaned checkpoint over the training
   split, with the minimal postprocessor (per-piece beat F equal to the
   overfit run's) and with `--dbn`, with exact launch counts;
7. the kernel summary JSON (launches: phases 4-6), then the device JSON as
   the last line.

Needs a CUDA device and the repository beside this script; it never runs
on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path
from typing import Optional

import numpy as np

F32_LIMIT = 1e-3  # relative max deviation, float32 with TF32 off
BF16_LIMIT = 2.5e-2  # relative max deviation, bfloat16 (tools/check_all_tpu.py:71)
F_MIN = 0.999  # beat F-measure of the kernel path against the float32 plain path
SR = 22050
HOP = 441
FPS = SR // HOP

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "fused_ff": ("beat_this_tpu_torch/csrc/fused_ff.cu", "beat_this_tpu/ops/fused_ff.py:55"),
    "fused_time_roformer": (
        "beat_this_tpu_torch/csrc/fused_time.cu", "beat_this_tpu/ops/fused_time.py:114"),
    "fused_freq_roformer": (
        "beat_this_tpu_torch/csrc/fused_freq.cu", "beat_this_tpu/ops/fused_freq.py:275"),
    "fused_time_attention_train_fwd": (
        "beat_this_tpu_torch/csrc/fused_time_train.cu", "beat_this_tpu/ops/fused_time.py:328"),
    "fused_time_attention_train_bwd": (
        "beat_this_tpu_torch/csrc/fused_time_train.cu", "beat_this_tpu/ops/fused_time.py:382"),
    "fused_ff_train_fwd": (
        "beat_this_tpu_torch/csrc/ff_train.cuh", "beat_this_tpu/ops/fused_ff.py:150"),
    "fused_ff_train_bwd": (
        "beat_this_tpu_torch/csrc/ff_train.cuh", "beat_this_tpu/ops/fused_ff.py:177"),
    "fused_freq_roformer_train_fwd": (
        "beat_this_tpu_torch/csrc/fused_freq.cu", "beat_this_tpu/ops/fused_freq.py:275"),
    "fused_freq_roformer_train_bwd": (
        "beat_this_tpu_torch/csrc/fused_freq_train.cu", "beat_this_tpu/ops/fused_freq.py:328"),
    "flash_attention_fwd": (
        "beat_this_tpu_torch/csrc/flash_attention.cu", "beat_this_tpu/ops/flash_attention.py:124"),
    "flash_attention_fwd_lse": (
        "beat_this_tpu_torch/csrc/flash_attention.cu", "beat_this_tpu/ops/flash_attention.py:131"),
    "flash_attention_bwd": (
        "beat_this_tpu_torch/csrc/flash_attention.cu", "beat_this_tpu/ops/flash_attention.py:189"),
    "small_attention_fwd": (
        "beat_this_tpu_torch/csrc/small_attention.cu", "beat_this_tpu/ops/small_attention.py:77"),
    "small_attention_bwd": (
        "beat_this_tpu_torch/csrc/small_attention.cu", "beat_this_tpu/ops/small_attention.py:110"),
    "freq_ablate": (
        "beat_this_tpu_torch/csrc/freq_ablate.cu", "tools/bench_fused_freq_ablate.py:47"),
    "flash_ablate": (
        "beat_this_tpu_torch/csrc/flash_attention.cu", "tools/bench_flash_ablate.py:27"),
    "softmax_variants": (
        "beat_this_tpu_torch/csrc/softmax_variants.cu", "tools/bench_softmax_variants.py:74"),
    "softmax_passes": (
        "beat_this_tpu_torch/csrc/softmax_passes.cu", "tools/bench_softmax_variants.py:177"),
}
ABLATION_KERNELS = ("freq_ablate", "flash_ablate", "softmax_variants", "softmax_passes")
ATTN_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_lse", "flash_attention_bwd",
                "small_attention_fwd", "small_attention_bwd")
TRAIN_KERNELS = ("fused_time_attention_train_fwd", "fused_time_attention_train_bwd",
                 "fused_ff_train_fwd", "fused_ff_train_bwd", "fused_freq_roformer_train_fwd",
                 "fused_freq_roformer_train_bwd")
FREQ_KERNELS = ("fused_freq_roformer_train_fwd", "fused_freq_roformer_train_bwd")
TRAIN_STEPS, TRAIN_ACCUM, TRAIN_LAYERS, FRONTEND_BLOCKS = 3, 2, 6, 3
# phase 3's training shapes, (items, n, C, heads): a full-width microbatch of
# 8 crops of 1500 frames through a main layer, then the frontend's three
# time blocks (8 crops x F bins of 1500 frames)
TRAIN_SHAPE = (8, 1500, 512, 16)
FRONTEND_TIME_SHAPES = ((256, 1500, 32, 1), (128, 1500, 64, 2), (64, 1500, 128, 4))
# the other widths `--transformer-dim` reaches, (items, n, C, heads), at small row counts
OTHER_WIDTH_SHAPES = ((2, 750, 256, 8), (2, 750, 384, 12))
# the frontend's three frequency blocks, (items, F, C): 8 crops x 1500 frames
FREQ_SHAPES = ((12000, 32, 32), (12000, 16, 64), (12000, 8, 128))
# the h16 model's attention per 1500-frame crop, (entries, seq, heads): a main
# layer (32 heads) and the frontend's time blocks (F bins x heads = 64
# sequences; block 0's 2 heads stand for 4 and 8, which differ only in the
# mask's coordinates), then its three frequency blocks (1500 frames x heads)
H16 = 16
H16_FLASH = ((32, 1500, 32), (64, 1500, 2))
H16_SMALL = ((3000, 32, 2), (6000, 16, 4), (12000, 8, 8))
# small_attention at head width 32, (entries, seq, D): the stock frontend's
# first frequency block at 8 crops of 1500 frames, F 32, one head
SMALL_D32 = (12000, 32, 32)
EVAL_CHUNKS, TRAIN_CROPS = 3, 8
# the ablation benches' sizes: chunks of 1500 frames per frequency-block
# launch, and the flash forward's (entries, seq, head_dim)
ABLATE_BATCH = 16
ABLATE_FLASH = (512, 1536, 32)
# instantiations of the tensor-core flash kernels in the library per dtype
# (float32 as split bf16 products): the forward's four modes at D 16 and 32,
# dq and dk/dv at both
FLASH_TC_KERNELS = {"flash_fwd_kernel": 8, "flash_dq_kernel": 2, "flash_dkv_kernel": 2}
# and of the small-sequence attention kernels (B12): F 1, 2, 4, 8, 16, 32 x D
# 16 and 32 per dtype; the dtype is their third template argument
SMALL_TC_KERNELS = {"small_fwd_kernel": 12, "small_bwd_kernel": 12}
# and of B7's attention core on the same tile (csrc/freq_core.cu): F 1, 2,
# 4, 8, 16, 32 per dtype, <F, T>; the head's columns of any width C
FREQ_CORE_TC_KERNELS = {"freq_core_fwd_kernel": 6, "freq_core_bwd_kernel": 6}
# instantiations of the products of the training kernels and of the eval
# kernels K1 and K2, each on the tensor cores in both dtypes (float32 as split
# bf16 products): the feed-forward forward (B8, and at eval K1 and K2's tail:
# hidden, out, and the depth-sliced output product at small row counts) and
# backward (B9: hidden, d_g and the weight gradients; the frequency block's
# backward instantiates B9's hidden and product kernels once more), the q/k/v
# product (B4's and K2's, in their sources), the
# attention core's forward (B4, and K2 at eval) and the out projections (B4's
# attn_out, K2's time_out), the attention branch's backward (B5: d_go, dq,
# dk/dv, d_gn and the weight gradients), the frequency block's backward (B7:
# q/k/v, out projection, d_og, d_g and the weight gradients) and its forward
# (K3 at eval, B6 in training: one kernel, 3 widths x 2 dtypes x eval / train)
TRAIN_TC_KERNELS = {"ff_hidden_kernel": 10, "ff_product_kernel": 26, "ff_out_kernel": 12,
                    "time_qkv_kernel": 8, "attn_fwd_kernel": 4, "attn_out_kernel": 4,
                    "time_out_kernel": 4, "attn_dgo_kernel": 4, "attn_dq_kernel": 2,
                    "attn_dkv_kernel": 2, "attn_product_kernel": 8, "freq_qkv_kernel": 4,
                    "freq_out_kernel": 4, "freq_dog_kernel": 4, "freq_product_kernel": 8}
# the frequency block's kernel by its STAGE argument (csrc/freq_block.cuh):
# instantiations, and whether they hold products. 5, the whole block: K3 at
# eval and B6 in training, 3 widths x 2 dtypes x 2; the cuts of B13 (eval, 3
# widths x 2 dtypes): 2 qkv, 3 ff, 4 attn with products, 0 copy and 1 rms
# without
FREQ_BLOCK_STAGES = {5: (12, True), 2: (6, True), 3: (6, True), 4: (6, True), 0: (6, False),
                     1: (6, False)}
# B15a's kernel, <T, variant>: the 11 softmax variants per dtype
VARIANT_TC_KERNELS = {"attn_variant_kernel": 11}
DEVICE = "cuda"
# the H100 SXM's published peaks (NVIDIA data sheet, dense): float32 outside
# the tensor cores, bfloat16 on them, float32 as three bfloat16 products of
# split operands on them, and the HBM3 rate
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "f32 split": 989e12 / 3}
PEAK_BYTES = 3.35e12
# kernels whose float32 products run as split bfloat16 products (their
# float32 bound takes that rate), and kernels whose backward phase 3 times by
# its device time (call_device_ms) rather than by events around the host's
# call
SPLIT_F32 = {"fused_ff", "fused_time_roformer", "fused_freq_roformer", "fused_ff_train_fwd",
             "fused_ff_train_bwd", "fused_time_attention_train_fwd",
             "fused_time_attention_train_bwd", "fused_freq_roformer_train_fwd",
             "fused_freq_roformer_train_bwd", "flash_attention_fwd", "flash_attention_fwd_lse",
             "flash_attention_bwd", "flash_ablate", "small_attention_fwd", "small_attention_bwd",
             "softmax_variants"}
DEVICE_TIMED = {"fused_ff_train_bwd", "fused_time_attention_train_bwd",
                "fused_freq_roformer_train_bwd"}
# the H100's top SM clock, 1.98 GHz, rounded up: a spin of t * SPIN_HZ
# cycles lasts at least t seconds; and library_kernels_ms's one key where it
# times the whole call
SPIN_HZ = 2.0e9
WHOLE_CALL = "the whole call"


def train_counters() -> dict:
    """The training kernels' wrappers, each with its `launches` count."""
    from beat_this_tpu_torch.ops import (
        flash_attention,
        fused_ff,
        fused_freq,
        fused_time,
        small_attention,
    )

    return {"flash_attention_fwd_lse": flash_attention.flash_fwd_lse,
            "flash_attention_bwd": flash_attention.flash_bwd,
            "small_attention_fwd": small_attention.small_fwd,
            "small_attention_bwd": small_attention.small_bwd,
            "fused_time_attention_train_fwd": fused_time.attn_train_fwd,
            "fused_time_attention_train_bwd": fused_time.attn_train_bwd,
            "fused_ff_train_fwd": fused_ff.ff_train_fwd,
            "fused_ff_train_bwd": fused_ff.ff_train_bwd,
            "fused_freq_roformer_train_fwd": fused_freq.freq_train_fwd,
            "fused_freq_roformer_train_bwd": fused_freq.freq_train_bwd}


def bound(flops: float, nbytes: float, dt: str) -> tuple[float, str]:
    """The least time (ms) the card could take for `flops` operations of
    type `dt` and `nbytes` moved, and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def block_work(kind: str, rows: int, c: int, seq: int, dt: str, backward: bool = False):
    """(FLOPs, bytes) a kernel must do and move: the products it needs (no
    recompute), x read and the output written once (plus dout read and dx
    written for a backward), each weight read once (and its float32
    gradient written). kind: "block" (a whole roformer block), "attn" (its
    attention branch), "ff" (its feed-forward residual); `seq`: keys per
    query (n for a time block, F for a frequency block)."""
    m = 4 * c
    attn_w, ff_w = 4 * c * c, 2 * c * m  # qkv + out, W1 + W2
    per_row = {"attn": 8 * c * c + 4 * seq * c, "ff": 4 * c * m,
               "block": 8 * c * c + 4 * seq * c + 4 * c * m}[kind]
    weights = {"attn": attn_w, "ff": ff_w, "block": attn_w + ff_w}[kind]
    size = 2 if dt == "bf16" else 4
    if backward:  # the input and weight products twice, the attention's 2.5x
        per_row = 2 * (per_row - 4 * seq * c * (kind != "ff")) + 10 * seq * c * (kind != "ff")
        return rows * per_row, 4 * rows * c * size + weights * (size + 4)
    return rows * per_row, 2 * rows * c * size + weights * size


def core_work(rows: int, c: int, seq: int, dt: str):
    """(FLOPs, bytes) of B7's attention core (csrc/freq_core.cu), forward
    and backward: per (row, head) S and P V (4 seq 32 FLOPs) forward, 2.5x
    that backward; the forward reads q | k | v and the gate and writes o
    and go's parts, the backward reads q | k | v and d_o and writes
    d_qkv's parts (float32 operands in three bf16 parts, bf16 one)."""
    size, parts = (2, 1) if dt == "bf16" else (4, 3)
    heads = c // 32
    flops = rows * heads * 4 * seq * 32
    fwd = rows * (3 * c * size + 4 * heads + c * size + 2 * parts * c)
    bwd = rows * (4 * c * size + 2 * parts * 3 * c)
    return (flops, fwd), (flops * 5 // 2, bwd)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def rel_dev(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def median_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median time in ms of `fn` on DEVICE, by the benches' own routine."""
    import torch

    from beat_this_tpu_torch.bench import timing

    return timing.median_ms(fn, torch.device(DEVICE), reps, warmup)


# -- phase 1 -----------------------------------------------------------------


def phase_environment() -> str:
    import torch

    smi = nvidia_smi_line()
    print(f"[env] gpu: {smi}")
    from beat_this_tpu_torch.ops import _build

    nvcc = subprocess.run(
        [_build._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    print(f"[env] torch.cuda.get_device_name(0) = {torch.cuda.get_device_name(0)}, "
          f"device_count = {torch.cuda.device_count()}")
    return smi


# -- phase 2 -----------------------------------------------------------------


def sass_hmma_counts(lib: Path) -> dict:
    """HMMA (tensor-core product) instructions per compiled function of the
    kernel library, by its mangled name, from `cuobjdump -sass`."""
    from beat_this_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


def template_dtype(name: str, kernel: str, index: int = 1) -> Optional[str]:
    """The dtype of a kernel's name by its template argument `index` (after
    that many integers: a flash kernel's <D, T, ...>, a small-sequence
    kernel's <F, D, T>), mangled (`kernelILi16EfLi0EE...` is float at D 16)
    or demangled."""
    if kernel + "<" in name:
        args = name.split(kernel + "<", 1)[1].split(",")[index].strip()
    else:
        args = re.sub(r"^(Li-?\d+E){%d}" % index, "", name.split(kernel + "I", 1)[-1])
    if args.startswith("f"):
        return "float32"
    if args.startswith(("13__nv_bfloat16", "__nv_bfloat16")):
        return "bfloat16"
    return None


def ptxas_lines(log: str, kernel: str) -> list:
    """One entry per compiled instantiation of `kernel` in ptxas's -v log:
    its mangled template arguments, registers and spill bytes."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1) if kernel in entry.group(1) else None
        elif name and "spill" in line:
            spill = "/".join(re.findall(r"(\d+) bytes spill", line))
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            args = name.split(kernel + "I", 1)[-1].split("EEv", 1)[0]
            out.append(f"{args} {regs.group(1) if regs else '?'} r, {spill}")
            name = None
    return out


def phase_build() -> None:
    from beat_this_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"[build] {path} in {time.perf_counter() - t0:.1f} s")
    log = path.parent / "build.log"
    if log.exists():
        text = log.read_text()
        for line in text.splitlines():
            if "spill" in line and not line.strip().endswith("0 bytes spill loads"):
                print(f"[build] ptxas: {line.strip()}")
        for kernel in SMALL_TC_KERNELS:
            print(f"[build] ptxas {kernel} <F, D, T>: registers, spill stores / loads: "
                  + "; ".join(ptxas_lines(text, kernel)))
        for kernel in FREQ_CORE_TC_KERNELS:
            print(f"[build] ptxas {kernel} <F, T>: registers, spill stores / loads: "
                  + "; ".join(ptxas_lines(text, kernel)))
        for kernel, args in (("attn_variant_kernel", "<T, variant>"),
                             ("freq_block_kernel", "<C, T, TRAIN, STAGE>")):
            print(f"[build] ptxas {kernel} {args}: registers, spill stores / loads: "
                  + "; ".join(ptxas_lines(text, kernel)))
    # the flash kernels run on the tensor cores in both dtypes: every
    # instantiation holds HMMA instructions, and none is left without
    counts = sass_hmma_counts(path)
    per_dtype = [(kernel, expect, 1) for kernel, expect in FLASH_TC_KERNELS.items()]
    per_dtype += [(kernel, expect, 2) for kernel, expect in SMALL_TC_KERNELS.items()]
    per_dtype += [(kernel, expect, 1) for kernel, expect in FREQ_CORE_TC_KERNELS.items()]
    per_dtype += [(kernel, expect, 0) for kernel, expect in VARIANT_TC_KERNELS.items()]
    for kernel, expect, index in per_dtype:
        found = {name: n for name, n in counts.items() if kernel in name}
        by_dtype = {dt: sorted(n for name, n in found.items()
                               if template_dtype(name, kernel, index) == dt)
                    for dt in ("float32", "bfloat16")}
        print(f"[build] HMMA per instantiation of {kernel}: float32 {by_dtype['float32']}; "
              f"bfloat16 {by_dtype['bfloat16']}")
        check(all(len(v) == expect for v in by_dtype.values()) and len(found) == 2 * expect
              and all(n > 0 for n in found.values()),
              f"{kernel}: {len(found)} instantiations (expected {expect} per dtype, each with "
              f"HMMA), HMMA counts {found}")
    for kernel, expect in TRAIN_TC_KERNELS.items():
        found = {name: n for name, n in counts.items() if kernel in name}
        print(f"[build] HMMA per instantiation of {kernel}: "
              + ", ".join(f"{name} {n}" for name, n in sorted(found.items())))
        check(len(found) == expect and all(n > 0 for n in found.values()),
              f"{kernel}: {len(found)} instantiations (expected {expect}), HMMA counts {found}")
    by_stage = {}
    for name, n in counts.items():
        stage = re.search(r"freq_block_kernel(?:ILi\d+E(?:f|13__nv_bfloat16)Lb[01]ELi(\d+)E|"
                          r"<\d+, (?:float|__nv_bfloat16), (?:true|false), (\d+)>)", name)
        if stage:
            by_stage.setdefault(int(stage.group(1) or stage.group(2)), []).append(n)
    print(f"[build] HMMA per instantiation of freq_block_kernel by STAGE: {by_stage}")
    for stage, (expect, products) in FREQ_BLOCK_STAGES.items():
        found = by_stage.get(stage, [])
        check(len(found) == expect and all((n > 0) == products for n in found),
              f"freq_block_kernel STAGE {stage}: {len(found)} instantiations (expected {expect}, "
              f"{'each with' if products else 'none with'} HMMA), HMMA counts {found}")
    check(sorted(by_stage) == sorted(FREQ_BLOCK_STAGES),
          f"freq_block_kernel: STAGE arguments {sorted(by_stage)}")


# -- phase 3 -----------------------------------------------------------------


def random_block(c: int, heads: int, seed: int, device):
    """An Attention and a FeedForward module with numpy-seeded weights at the
    scales the JAX package's kernel tests use."""
    import torch

    from beat_this_tpu_torch.model.layers import Attention, FeedForward

    rng = np.random.default_rng(seed)
    m = 4 * c

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    attn, ff = Attention(c, heads), FeedForward(c)
    with torch.no_grad():
        attn.norm.gamma.copy_(t(1 + 0.1 * rng.standard_normal(c)))
        attn.to_qkv.weight.copy_(t(rng.standard_normal((3 * c, c)) / np.sqrt(c)))
        attn.to_gates.weight.copy_(t(rng.standard_normal((heads, c)) / np.sqrt(c)))
        attn.to_gates.bias.copy_(t(0.3 * rng.standard_normal(heads)))
        attn.to_out[0].weight.copy_(t(rng.standard_normal((c, c)) / np.sqrt(c)))
        norm, lin1, _, _, lin2, _ = ff.net
        norm.gamma.copy_(t(1 + 0.1 * rng.standard_normal(c)))
        lin1.weight.copy_(t(rng.standard_normal((m, c)) / np.sqrt(c)))
        lin1.bias.copy_(t(0.1 * rng.standard_normal(m)))
        lin2.weight.copy_(t(rng.standard_normal((c, m)) / np.sqrt(m)))
        lin2.bias.copy_(t(0.1 * rng.standard_normal(c)))
    return attn.to(device).requires_grad_(False), ff.to(device).requires_grad_(False)


def phase_kernels(smi: str, only: tuple = ()) -> dict:
    """Each eval kernel (K1, K2, K3) against its plain version in both
    dtypes at the main paths' shapes, with median times; `only`: the kernel
    names to run (all when empty)."""
    import torch

    from beat_this_tpu_torch.ops.fused_ff import fused_ff, fused_ff_ref
    from beat_this_tpu_torch.ops.fused_freq import fused_freq_roformer, fused_freq_roformer_ref
    from beat_this_tpu_torch.ops.fused_time import fused_time_roformer, fused_time_roformer_ref
    from beat_this_tpu_torch.ops.rotary import rope_tables

    dev = torch.device("cuda", 0)
    cases = []
    # K2: a main transformer layer over 2 chunks, frontend block 0's time
    # direction (B * F = 64 sequences of C = 32), a main layer over a whole
    # forward batch of 16 chunks (inference.py:CHUNK_BATCH: a long piece or
    # a directory batch)
    for c, heads, n, items in ((512, 16, 1500, 2), (32, 1, 1500, 64), (256, 8, 750, 2),
                               (384, 12, 750, 2), (512, 16, 1500, 16)):
        attn, ff = random_block(c, heads, c + n, dev)
        cos, sin = rope_tables(n, 32, dev)
        cases.append(("fused_time_roformer", f"C={c} heads={heads} n={n} items={items}",
                      (items, n, c), ("block", n),
                      lambda x, a=attn, f=ff, cs=cos, sn=sin, h=heads:
                          fused_time_roformer(x, a, f, cs, sn, h),
                      lambda x, a=attn, f=ff, cs=cos, sn=sin, h=heads:
                          fused_time_roformer_ref(x, a, f, cs, sn, h)))
    # K3: frontend blocks 0 and 2 over 2 chunks (B * T = 3000 items)
    for f_bins, c, items in ((32, 32, 3000), (8, 128, 3000)):
        attn, ff = random_block(c, c // 32, f_bins + c, dev)
        cos, sin = rope_tables(f_bins, 32, dev)
        cases.append(("fused_freq_roformer", f"F={f_bins} C={c} items={items}",
                      (items, f_bins, c), ("block", f_bins),
                      lambda x, a=attn, f=ff, cs=cos, sn=sin: fused_freq_roformer(x, a, f, cs, sn),
                      lambda x, a=attn, f=ff, cs=cos, sn=sin:
                          fused_freq_roformer_ref(x, a, f, cs, sn)))
    # K1: the short-piece path at a 768-frame bucket: a main layer (1 x 768
    # rows of C = 512) and frontend block 0's time FF (32 x 768 rows of C = 32)
    for c, items, n in ((512, 1, 768), (32, 32, 768), (256, 1, 768), (384, 1, 768)):
        _, ff = random_block(c, c // 32, 7 * c, dev)
        cases.append(("fused_ff", f"C={c} rows={items * n}", (items, n, c), ("ff", n),
                      lambda x, f=ff: fused_ff(x, f),
                      lambda x, f=ff: fused_ff_ref(x, f)))

    results = {name: [] for name in KERNELS}
    cases = [case for case in cases if not only or case[0] in only]
    for dtype, limit in ((torch.float32, F32_LIMIT), (torch.bfloat16, BF16_LIMIT)):
        for name, desc, shape, (kind, seq), kernel, plain in cases:
            gen = torch.Generator(device=dev).manual_seed(len(results[name]))
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            with torch.inference_mode():
                got = kernel(x)
                want = plain(x)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got.float()).all()), f"{name} {desc}: non-finite")
                dev_rel = rel_dev(got, want)
                abs_err = float((got.float() - want.float()).abs().max())
                ms = median_ms(lambda: kernel(x))
                plain_ms = median_ms(lambda: plain(x))
            dt = "f32" if dtype == torch.float32 else "bf16"
            ok = dev_rel <= limit if dtype == torch.float32 else dev_rel < limit
            bound_ms, bound_by = bound(*block_work(kind, shape[0] * shape[1], shape[2], seq, dt),
                                       "f32 split" if dt == "f32" and name in SPLIT_F32 else dt)
            print(f"[kernels] {name} {dt} {desc}: rel max dev {dev_rel:.3e} (limit {limit:g}) "
                  f"abs {abs_err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.3f} ms ({bound_by}) [{smi}] {'ok' if ok else 'FAIL'}")
            check(ok, f"{name} {dt} {desc}: deviation {dev_rel:.3e} over {limit:g}")
            results[name].append({"case": f"{dt} {desc}", "rel_max_dev": dev_rel,
                                  "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": bound_ms, "bound_by": bound_by})
    return results


# -- phase 4 -----------------------------------------------------------------


def click_onsets(frames: int) -> np.ndarray:
    """Onset times (s) of the click track: 120 bpm from 0.25 s; every fourth
    click, from the first, is a downbeat, louder and higher as a
    metronome's."""
    return np.arange(0.25, (frames - 1) * HOP / SR, 0.5)


def click_frames(frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Frames where the beat and downbeat logits should peak: the first
    frame centred after each onset, which holds the click's attack."""
    beats = np.floor(click_onsets(frames) * FPS) + 1
    return beats, beats[::4]


def write_wav(path: Path, frames: int, seed: int) -> float:
    """A 16-bit click track (click_onsets) plus noise, long enough for
    `frames` model frames; returns its duration in seconds."""
    rng = np.random.default_rng(seed)
    n = (frames - 1) * HOP
    t = np.arange(n) / SR
    x = 0.02 * rng.standard_normal(n)
    for i, onset in enumerate(click_onsets(frames)):
        k = int(onset * SR)
        seg = t[: min(2205, n - k)]
        amp, hz = (0.6, 1500) if i % 4 == 0 else (0.3, 1000)
        x[k : k + len(seg)] += amp * np.sin(2 * np.pi * hz * seg) * np.exp(-seg / 0.02)
    pcm = np.clip(np.round(x * 32767), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())
    return n / SR


def read_beats(path: Path) -> tuple[np.ndarray, np.ndarray]:
    rows = [line.split("\t") for line in path.read_text().splitlines() if line.strip()]
    times = np.array([float(r[0]) for r in rows])
    numbers = np.array([int(r[1]) for r in rows])
    return times, times[numbers == 1]


def f_measure(est: np.ndarray, ref: np.ndarray, window: float = 0.07) -> float:
    """Beat F-measure with a +/-70 ms window and one-to-one greedy matching."""
    if len(est) == 0 and len(ref) == 0:
        return 1.0
    if len(est) == 0 or len(ref) == 0:
        return 0.0
    used = np.zeros(len(est), bool)
    hits = 0
    for r in ref:
        d = np.abs(est - r)
        d[used] = np.inf
        j = int(np.argmin(d))
        if d[j] <= window:
            used[j] = True
            hits += 1
    p, r = hits / len(est), hits / len(ref)
    return 0.0 if hits == 0 else 2 * p * r / (p + r)


def read_pcm(path: Path) -> np.ndarray:
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def fit_head(state: dict, config, spect, frames: int) -> str:
    """Set the task head of `state` to the ridge least-squares fit, on the
    plain float32 path's features of `spect` (two chunk-long windows that
    cover it), of targets that are +1 at the click frames, fall off over
    about a frame and are -1 elsewhere. Frames with positive and negative
    targets weigh half each, so the rare downbeats are not fit towards the
    background. Returns a line on the fit."""
    import torch

    from beat_this_tpu_torch.model import BeatThis

    model = BeatThis(config)
    model.load_state_dict(state)
    model = model.to(spect.device).eval()
    t = len(spect)
    pos = np.arange(t)

    def bumps(centers):
        d = np.abs(pos[:, None] - centers[None, :]).min(1)
        return -1.0 + 2.0 * np.exp(-0.5 * d.astype(np.float64) ** 2)

    targets = torch.from_numpy(np.stack([bumps(c) for c in click_frames(frames)], 1))
    targets = targets.to(spect.device)
    xs, ys = [], []
    with torch.inference_mode():
        for a in sorted({0, max(t - 1500, 0)}):
            h = model.features(spect[None, a : a + 1500], kernels=False)[0].double()
            xs.append(torch.cat([h, torch.ones_like(h[:, :1])], 1))
            ys.append(targets[a : a + 1500])
    x, y = torch.cat(xs), torch.cat(ys)
    coef = []
    for target in y.T:
        positive = target > 0
        weight = torch.where(positive, 0.5 / positive.sum(), 0.5 / (~positive).sum())
        gram = (x * weight[:, None]).T @ x
        gram.diagonal()[:-1] += 1e-3 * gram.diagonal()[:-1].mean()  # ridge, bias unpenalized
        coef.append(torch.linalg.solve(gram, (x * weight[:, None]).T @ target))
    coef = torch.stack(coef, 1)  # (C + 1, 2)
    rms = float((x @ coef - y).square().mean().sqrt())
    w, b = coef[:-1].T.float().cpu(), coef[-1].float().cpu()
    if config.sum_head:  # the beat logit is the sum of both head outputs
        w[0] -= w[1]
        b[0] -= b[1]
    state["task_heads.beat_downbeat_lin.weight"] = w
    state["task_heads.beat_downbeat_lin.bias"] = b
    return (f"head fit on {len(x)} frames: target rms residual {rms:.3f}, "
            f"weight norm {float(w.norm()):.2f}")


def phase_end_to_end(smi: str) -> dict:
    """The CLI on the stock checkpoint, then on the head_dim 16 one; the
    launches of both."""
    launches = {}
    for head_dim in (32, H16):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            for k, v in _end_to_end(Path(tmp), smi, head_dim).items():
                launches[k] = launches.get(k, 0) + v
    for k, n in launches.items():
        check(n > 0 or k == "flash_attention_fwd_lse",
              f"kernel {k} was never launched on the main path")
    del launches["flash_attention_fwd_lse"]  # a training kernel: phase 5 counts it
    return launches


# launches per CLI run (one forward of the 75 s piece's three chunks, or of
# the masked 12 s piece) of the head_dim 16 model: 3 frontend and 6 main time
# blocks, 3 frequency blocks, 12 feed-forwards; the masked time blocks run
# plain attention as in the JAX package
H16_EVAL_LAUNCHES = {
    "long": {"flash_attention_fwd": 9, "small_attention_fwd": 3, "fused_ff": 12},
    "short": {"flash_attention_fwd": 0, "small_attention_fwd": 3, "fused_ff": 12},
}


def _end_to_end(tmp: Path, smi: str, head_dim: int) -> dict:
    import torch
    from torch import nn

    from beat_this_tpu_torch import cli
    from beat_this_tpu_torch.inference import Audio2Beats, ChunkedPredictor
    from beat_this_tpu_torch.io.checkpoint import init_beat_this
    from beat_this_tpu_torch.model import BeatThisConfig
    from beat_this_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_lse
    from beat_this_tpu_torch.ops.fused_ff import fused_ff
    from beat_this_tpu_torch.ops.fused_freq import fused_freq_roformer
    from beat_this_tpu_torch.ops.fused_time import fused_time_roformer
    from beat_this_tpu_torch.ops.mel import log_mel_spectrogram
    from beat_this_tpu_torch.ops.small_attention import small_fwd

    counters = {"fused_ff": fused_ff, "fused_time_roformer": fused_time_roformer,
                "fused_freq_roformer": fused_freq_roformer, "flash_attention_fwd": flash_fwd,
                "flash_attention_fwd_lse": flash_fwd_lse, "small_attention_fwd": small_fwd}
    h16 = head_dim != 32
    tag = f"e2e h{head_dim}" if h16 else "e2e"

    class Composable(nn.Module):
        """The model with every router on its composable path (the kernels'
        plain versions)."""

        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, x, **kwargs):
            return self.model(x, kernels=False, **kwargs)

    pieces = {"long": (tmp / "long.wav", 3750), "short": (tmp / "short.wav", 601)}
    durations = {k: write_wav(p, frames, i) for i, (k, (p, frames)) in enumerate(pieces.items())}
    config = BeatThisConfig(head_dim=head_dim)
    state = init_beat_this(0, config)
    # a trained checkpoint's input batch norm holds the log-mel statistics of
    # its data; with the init's identity statistics the log-mel offset (~3.5)
    # swamps the random network and its logits hardly vary. Its head makes
    # the logits peak at beats; with a random head they are noise-like and
    # rounding moves their peaks.
    mel = log_mel_spectrogram(torch.from_numpy(read_pcm(pieces["long"][0]).copy()).cuda())
    state["frontend.stem.bn1d.running_mean"] = mel.mean(0).cpu()
    state["frontend.stem.bn1d.running_var"] = mel.var(0).cpu()
    fit = fit_head(state, config, mel, pieces["long"][1])
    n_params = sum(v.numel() for k, v in state.items() if "running" not in k)
    ckpt = tmp / "synthetic.ckpt"
    torch.save({"state_dict": {"model." + k: v for k, v in state.items()},
                "hyper_parameters": {"head_dim": head_dim} if h16 else {}}, ckpt)
    print(f"[{tag}] synthetic checkpoint: {config}, {n_params} parameters, "
          f"seed 0, input batch norm from the long piece's log-mel statistics, {fit}")

    def run_cli(wav: Path, out: Path, float16: bool) -> float:
        t0 = time.perf_counter()
        cli.run([str(wav)], str(ckpt), str(out), ".beats", False, False, False, False,
                0, float16, False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for float16 in (False, True):  # CUDA context, library load, cuDNN algorithm choice
        run_cli(pieces["short"][0], tmp / "warmup.beats", float16)

    runs = []
    for name in counters:
        counters[name].launches = 0
    for piece, (wav, frames) in pieces.items():
        for float16 in (False, True):
            before = {k: fn.launches for k, fn in counters.items()}
            out = tmp / f"{piece}{'_bf16' if float16 else ''}.beats"
            wall = run_cli(wav, out, float16)
            delta = {k: fn.launches - before[k] for k, fn in counters.items()}
            runs.append((piece, float16, out, wall, delta))
    launches = {k: fn.launches for k, fn in counters.items()}

    for piece, float16, out, wall, delta in runs:
        dt = "bf16" if float16 else "f32"
        print(f"[{tag}] cli {piece} ({durations[piece]:.1f} s audio) {dt}: {wall:.3f} s wall "
              f"(checkpoint load included), {durations[piece] / wall:.1f}x realtime, "
              f"launches {delta} [{smi}]")
        if h16:
            want = {k: H16_EVAL_LAUNCHES[piece].get(k, 0) for k in counters}
            check(delta == want, f"{tag} {piece} {dt}: launches {delta}, expected {want}")
            continue
        expect = (("fused_time_roformer", "fused_freq_roformer") if piece == "long"
                  else ("fused_ff", "fused_freq_roformer"))
        for k in expect:
            check(delta[k] > 0, f"{piece} {dt}: kernel {k} was not launched")
        for k in ("flash_attention_fwd", "flash_attention_fwd_lse", "small_attention_fwd"):
            check(delta[k] == 0, f"{piece} {dt}: kernel {k} launched on the stock path")

    # references from the plain path on the card, float32
    tower = Audio2Beats(str(ckpt), "cuda", False)
    refs = {}
    for piece, (wav, frames) in pieces.items():
        spect = tower.signal2spect(read_pcm(wav) / 32768.0, SR)
        check(spect.shape == (frames, 128), f"{piece}: spect shape {spect.shape}")
        logits = ChunkedPredictor(Composable(tower.model)).predict(spect)
        refs[piece] = (spect, logits, tower.frames2beats(*logits))

    for piece, float16, out, _, _ in runs:
        dt = "bf16" if float16 else "f32"
        spect, ref_logits, (ref_beats, ref_down) = refs[piece]
        beats, downbeats = read_beats(out)
        check(len(beats) > 0 and len(downbeats) > 0 and bool(np.all(np.diff(beats) > 0)),
              f"{out.name}: bad beats")
        tower = Audio2Beats(str(ckpt), "cuda", float16)
        got = tower.spect2frames(spect)
        plain = ref_logits
        if float16:
            plain = ChunkedPredictor(
                Composable(tower.model), compute_dtype=torch.bfloat16
            ).predict(spect)
        for g in got:
            check(g.shape == (len(spect),) and bool(np.isfinite(g).all()), f"{piece}: bad logits")
        dev_rel = max(rel_dev(torch.from_numpy(g), torch.from_numpy(w)) for g, w in zip(got, plain))
        limit = BF16_LIMIT if float16 else F32_LIMIT
        f_beat, f_down = f_measure(beats, ref_beats), f_measure(downbeats, ref_down)
        true_beats, true_down = (f / FPS for f in click_frames(pieces[piece][1]))
        print(f"[{tag}] {piece} {dt}: logits vs plain {dt} path rel max dev {dev_rel:.3e} "
              f"(limit {limit:g}); vs plain f32 beats: beats {len(beats)} F {f_beat:.4f}, "
              f"downbeats {len(downbeats)} F {f_down:.4f} (min {F_MIN}); vs the clicks "
              f"({len(true_beats)} / {len(true_down)}): F {f_measure(beats, true_beats):.4f} / "
              f"{f_measure(downbeats, true_down):.4f}")
        check(dev_rel < limit if float16 else dev_rel <= limit,
              f"{piece} {dt}: logits deviate {dev_rel:.3e}")
        check(f_beat >= F_MIN and f_down >= F_MIN, f"{piece} {dt}: beats disagree")
    if not h16:
        _dbn_and_directory(tmp, smi, ckpt, pieces, refs, durations)
    return launches


def _dbn_and_directory(tmp: Path, smi: str, ckpt: Path, pieces: dict, refs: dict,
                       durations: dict) -> None:
    """The stock checkpoint through `--dbn` on the long piece, and through
    directory mode (groups of files sharing their forwards) over four wavs
    of unequal length."""
    import torch

    from beat_this_tpu_torch import cli
    from beat_this_tpu_torch.ops.fused_time import fused_time_roformer
    from beat_this_tpu_torch.postprocessing.postprocessor import Postprocessor

    def run_cli(inputs, out: Path, dbn: bool = False) -> float:
        t0 = time.perf_counter()
        cli.run([str(i) for i in inputs], str(ckpt), str(out), ".beats", False, False, False, dbn,
                0, False, False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = tmp / "long_dbn.beats"
    run_cli([pieces["long"][0]], tmp / "warm_dbn.beats", True)
    wall = run_cli([pieces["long"][0]], out, True)
    beats, downbeats = read_beats(out)
    peak_beats, peak_down = read_beats(tmp / "long.beats")
    ref_beats, ref_down = Postprocessor("dbn", device=DEVICE)(*refs["long"][1])
    f_beat, f_down = f_measure(beats, peak_beats), f_measure(downbeats, peak_down)
    same = (len(beats) == len(ref_beats) and len(downbeats) == len(ref_down)
            and bool(np.allclose(beats, ref_beats, atol=1e-3))
            and bool(np.allclose(downbeats, ref_down, atol=1e-3)))
    print(f"[e2e] cli --dbn long ({durations['long']:.1f} s audio) f32: {wall:.3f} s wall, "
          f"{durations['long'] / wall:.1f}x realtime; {len(beats)} beats / {len(downbeats)} "
          f"downbeats; vs the minimal postprocessor's: F {f_beat:.4f} / {f_down:.4f} (beats min "
          f"{F_MIN}); equal to the DBN decode of the plain f32 path's logits: {same} [{smi}]")
    check(f_beat >= F_MIN, "--dbn: beats disagree with the minimal postprocessor's")
    check(same, "--dbn: beats differ from the DBN decode of the plain path's logits")

    src = tmp / "dir"
    src.mkdir()
    lengths = (3750, 601, 1600, 250)
    seconds = sum(write_wav(src / f"p{i}.wav", frames, 10 + i) for i, frames in enumerate(lengths))
    before = fused_time_roformer.launches
    wall_dir = run_cli([src], tmp / "dir_out")
    check(fused_time_roformer.launches > before, "directory mode launched no kernel")
    wall_single = sum(run_cli([src / f"p{i}.wav"], tmp / "single" / f"p{i}.beats")
                      for i in range(len(lengths)))
    for i in range(len(lengths)):
        got = (tmp / "dir_out" / f"p{i}.beats").read_bytes()
        check(len(got) > 0 and got == (tmp / "single" / f"p{i}.beats").read_bytes(),
              f"directory mode: p{i}.beats differs from the single-file run")
    print(f"[e2e] directory mode, {len(lengths)} wavs of {lengths} frames ({seconds:.1f} s "
          f"audio): {wall_dir:.3f} s wall ({seconds / wall_dir:.1f}x realtime), the four "
          f"single-file runs {wall_single:.3f} s; .beats files byte-identical [{smi}]")


# -- phase 3b: training kernels -------------------------------------------------


def grads_of(fn, x, params, cot):
    """Output, dx and the parameter gradients of sum(fn(x) * cot)."""
    import torch

    for p in params:
        p.grad = None
    x = x.detach().clone().requires_grad_(True)
    out = fn(x)
    torch.autograd.backward(out, (cot.to(out.dtype),))
    return [out.detach(), x.grad] + [p.grad.clone() for p in params]


def fwd_bwd_ms(fn, x, params, cot, reps: int) -> tuple[float, float]:
    """Median forward time (autograd graph built, as in training) and median
    backward time on a retained graph."""
    import torch

    xg = x.detach().clone().requires_grad_(True)
    fwd = median_ms(lambda: fn(xg), reps)
    out = fn(xg)
    inputs = [xg] + params
    bwd = median_ms(lambda: torch.autograd.grad(out, inputs, cot.to(out.dtype),
                                                retain_graph=True), reps)
    return fwd, bwd


def call_device_ms(fn, reps: int = 20, windows: int = 3) -> float:
    """Device time in ms of one call of `fn`, without the host's launch and
    autograd time: CUDA events around `reps` calls queued behind a spin
    kernel (`torch.cuda._sleep`) twice as long as the host takes to launch
    them, so that the host has launched them all before the card reaches
    the first; the median over `windows` windows after one warm-up call.
    Where the card reached the start event before the host had launched
    every call, the window runs once more with a spin twice as long; where
    it is still short, `fn` waits on the card (a sync, or more launches than
    the card's queue holds), and the rest run without a spin, as events
    around the calls, with a note. (torch.profiler is not used for this: in a long process it
    records no device event in some of its windows, and then in all.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spin_s = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    per_call, exposed = [], 0
    for _ in range(windows):
        for attempt in (1, 2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if spin_s:
                torch.cuda._sleep(int(attempt * spin_s * SPIN_HZ))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            hidden = not start.query()
            end.synchronize()
            if hidden or not spin_s:
                break
        if not hidden:
            exposed, spin_s = exposed + 1, 0.0
        per_call.append(start.elapsed_time(end) / reps)
    if exposed:
        print(f"[timing] {exposed} of {windows} windows as events around the calls: the call "
              f"waits on the card (a sync or a full launch queue), so no spin keeps the host "
              f"ahead of it", flush=True)
    return statistics.median(per_call)


def kernel_device_ms(fn, name: str, reps: int = 10, windows: int = 3) -> float:
    """Device time in ms of the one kernel whose name holds `name` that each
    call of `fn` launches (the call's other launches not counted): the mean
    of the launches of it that torch.profiler recorded in a window of 2 reps
    calls, the median over `windows` windows with at least `reps` of them.
    In a long process the profiler drops launches from its windows, so a sum
    over a window would read low; each launch it records is whole. Where
    the profiler records too few in `2 windows` windows, the whole call by
    `call_device_ms`, with a note."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(2 * windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2 * reps):
                fn()
            torch.cuda.synchronize()
        us = [e.device_time_total for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if len(us) >= reps:
            per_call.append(sum(us) / len(us) / 1e3)
        if len(per_call) == windows:
            return statistics.median(per_call)
    print(f"[timing] torch.profiler recorded under {reps} launches of {name or 'a kernel'} "
          f"in a window: the whole call timed by call_device_ms", flush=True)
    return call_device_ms(fn, reps, windows)


def library_kernels_ms(fn, reps: int = 10, windows: int = 3) -> dict:
    """Device time in ms per call of each kernel of the port's library that
    a call of `fn` launches, by kernel name (torch's own kernels, `at::`,
    and copies left out): the mean of its launches torch.profiler recorded
    in a window of `reps` calls times its launches per call (the most of
    them one window recorded, over `reps`), the median over `windows`
    windows. Each launch the profiler records is whole, so the sum over
    kernels holds the whole call where a window's sum would read low for
    the launches the profiler dropped. Where the profiler records no launch
    of the library, {WHOLE_CALL: the whole call by `call_device_ms`}, with
    a note."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_launch, counts = {}, {}
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA and "at::" not in e.name
                    and not e.name.startswith(("Memcpy", "Memset"))):
                seen.setdefault(e.name, []).append(e.device_time_total)
        for name, us in seen.items():
            per_launch.setdefault(name, []).append(sum(us) / len(us) / 1e3)
            counts[name] = max(counts.get(name, 0), len(us))
    if not per_launch:
        print("[timing] torch.profiler recorded no launch of the kernel library: the whole "
              "call timed by call_device_ms", flush=True)
        return {WHOLE_CALL: call_device_ms(fn, reps, windows)}
    return {name: statistics.median(ms) * max(1, round(counts[name] / reps))
            for name, ms in per_launch.items()}


def bwd_device_ms(fn, x, params, cot, reps: int) -> float:
    """Device time in ms of one backward on a retained graph
    (call_device_ms)."""
    import torch

    xg = x.detach().clone().requires_grad_(True)
    out = fn(xg)
    inputs, cot = [xg] + params, cot.to(out.dtype)
    return call_device_ms(lambda: torch.autograd.grad(out, inputs, cot, retain_graph=True), reps)


def train_cases(dev, dtype, dt: str):
    """Phase 3's training cases in `dtype`: (kernel names, description,
    parameters, kernel, plain version, input shape, gradient names, rate,
    (forward, backward) (FLOPs, bytes))."""
    from beat_this_tpu_torch.ops import fused_ff as ff_ops
    from beat_this_tpu_torch.ops import fused_freq as freq_ops
    from beat_this_tpu_torch.ops import fused_time as time_ops
    from beat_this_tpu_torch.ops.rotary import rope_tables

    attn_names = ["dgamma", "dWqkv", "dWgates", "dgate_b", "dWout"]
    ff_names = ["dgamma_ff", "dW1", "db1", "dW2", "db2"]
    time_shapes = ([(TRAIN_SHAPE, (0.0, 0.2))] + [(s, (0.1,)) for s in FRONTEND_TIME_SHAPES]
                   + [(s, (0.2,)) for s in OTHER_WIDTH_SHAPES])
    for (items, n, c, heads), rates in time_shapes:
        attn, ff = random_block(c, heads, 2 * c + n, dev)
        attn.requires_grad_(True)
        ff.requires_grad_(True)
        cos, sin = rope_tables(n, 32, dev)
        rows = items * n
        for rate in rates:
            yield (("fused_time_attention_train_fwd", "fused_time_attention_train_bwd"),
                   f"rate {rate} x ({items}, {n}, {c}) heads {heads}", list(attn.parameters()),
                   lambda t, a=attn, cs=cos, sn=sin, h=heads, r=rate:
                       time_ops.fused_time_attention_train(t, a, cs, sn, h, r, 17),
                   lambda t, a=attn, cs=cos, sn=sin, h=heads, r=rate:
                       time_ops.fused_time_attention_train_ref(t, a, cs, sn, h, r, 17),
                   (items, n, c), attn_names, rate,
                   (block_work("attn", rows, c, n, dt), block_work("attn", rows, c, n, dt, True)))
            yield (("fused_ff_train_fwd", "fused_ff_train_bwd"),
                   f"rate {rate} rows {rows} C {c} hidden {4 * c}", list(ff.parameters()),
                   lambda t, f=ff, r=rate: ff_ops.fused_ff_train(t, f, r, 19),
                   lambda t, f=ff, r=rate: ff_ops.fused_ff_train_ref(t, f, r, 19),
                   (items, n, c), ff_names, rate,
                   (block_work("ff", rows, c, n, dt), block_work("ff", rows, c, n, dt, True)))
    for items, f_bins, c in FREQ_SHAPES:
        attn, ff = random_block(c, c // 32, f_bins + 3 * c, dev)
        attn.requires_grad_(True)
        ff.requires_grad_(True)
        cos, sin = rope_tables(f_bins, 32, dev)
        rows = items * f_bins
        for rate in (0.0, 0.1):
            yield (FREQ_KERNELS, f"rate {rate} x ({items}, {f_bins}, {c}) heads {c // 32}",
                   list(attn.parameters()) + list(ff.parameters()),
                   lambda t, a=attn, f=ff, cs=cos, sn=sin, r=rate:
                       freq_ops.fused_freq_roformer_train(t, a, f, cs, sn, r, 23),
                   lambda t, a=attn, f=ff, cs=cos, sn=sin, r=rate:
                       freq_ops.fused_freq_roformer_train_ref(t, a, f, cs, sn, r, 23),
                   (items, f_bins, c), attn_names + ff_names, rate,
                   (block_work("block", rows, c, f_bins, dt),
                    block_work("block", rows, c, f_bins, dt, True)))


def phase_train_kernels(smi: str, only: tuple = ()) -> dict:
    """Each training kernel pair (forward and backward) against its plain
    version on the same inputs, seeds and cotangent: the output, dx and
    every parameter gradient, at dropout 0 and on; median times. `only`:
    the kernel names whose pairs run (all when empty)."""
    import torch

    dev = torch.device(DEVICE)
    results = {name: [] for name in TRAIN_KERNELS}
    for dtype, limit in ((torch.float32, F32_LIMIT), (torch.bfloat16, BF16_LIMIT)):
        dt = "f32" if dtype == torch.float32 else "bf16"
        for i, (names, desc, params, kernel, plain, shape, pnames, rate, work) in enumerate(
                train_cases(dev, dtype, dt)):
            if only and not set(names) & set(only):
                continue
            gen = torch.Generator(device=dev).manual_seed(2 * i + (dtype == torch.float32))
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            cot = torch.randn(shape, generator=gen, device=dev)
            got = grads_of(kernel, x, params, cot)
            want = grads_of(plain, x, params, cot)
            torch.cuda.synchronize()
            devs = {g: rel_dev(a, b) for g, a, b in zip(["out", "dx"] + pnames, got, want)}
            abs_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
            finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
            del got, want
            ms = fwd_bwd_ms(kernel, x, params, cot, 10)
            plain_ms = fwd_bwd_ms(plain, x, params, cot, 5)
            by_device = names[1] in DEVICE_TIMED
            events_ms = (ms[1], plain_ms[1])
            core, split_note = {}, ""
            if by_device:
                plain_ms = (plain_ms[0], bwd_device_ms(plain, x, params, cot, 5))
            if by_device and names[1] != "fused_freq_roformer_train_bwd":
                ms = (ms[0], bwd_device_ms(kernel, x, params, cot, 10))
            elif by_device:
                # B7 by the device time of its own launches, its attention core apart
                xg = x.detach().clone().requires_grad_(True)
                out = kernel(xg)
                per = library_kernels_ms(lambda: torch.autograd.grad(
                    out, [xg] + params, cot.to(out.dtype), retain_graph=True))
                del out
                ms = (ms[0], sum(per.values()))
                if WHOLE_CALL in per:
                    split_note = " (B7's whole backward: its kernels not told apart)"
                else:
                    core = {part: sum(v for k, v in per.items()
                                      if f"freq_core_{part}_kernel" in k)
                            for part in ("fwd", "bwd")}
                    core_bound = [bound(*w, "f32 split" if dt == "f32" else dt)[0] for w in
                                  core_work(shape[0] * shape[1], shape[2], shape[1], dt)]
                    split_note = (f" (B7 by its own {len(per)} kernels' launches: attention "
                                  f"core fwd {core['fwd']:.3f} ms (bound {core_bound[0]:.3f} "
                                  f"ms), bwd {core['bwd']:.3f} ms (bound {core_bound[1]:.3f} "
                                  f"ms), the rest {ms[1] - core['fwd'] - core['bwd']:.3f} ms)")
            torch.cuda.empty_cache()
            worst = max(devs.values())
            ok = finite and (worst <= limit if dtype == torch.float32 else worst < limit)
            bounds = [bound(*w, "f32 split" if dt == "f32" and name in SPLIT_F32 else dt)
                      for w, name in zip(work, names)]
            print(f"[train-kernels] {names[0][:-4]} {dt} {desc}: rel max dev "
                  + " ".join(f"{g} {v:.2e}" for g, v in devs.items())
                  + f" (limit {limit:g}); fwd kernel {ms[0]:.3f} ms plain {plain_ms[0]:.3f} ms "
                  f"bound {bounds[0][0]:.3f} ms ({bounds[0][1]}), bwd kernel {ms[1]:.3f} ms "
                  f"plain {plain_ms[1]:.3f} ms bound {bounds[1][0]:.3f} ms ({bounds[1][1]})"
                  + (f" (device time; events around the call: kernel {events_ms[0]:.3f} ms "
                     f"plain {events_ms[1]:.3f} ms)" if by_device else "") + split_note
                  + f" [{smi}] {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"{names[0]} {dt} {desc}: deviation {worst:.3e} over {limit:g}"
                      f" or non-finite ({devs})")
            for k, name in enumerate(names):
                results[name].append({
                    "case": f"{dt} {desc}", "rel_max_dev": worst, "max_abs_err": abs_err,
                    "ms": ms[k], "plain_ms": plain_ms[k], "bound_ms": bounds[k][0],
                    "bound_by": bounds[k][1]})
                if k == 1 and by_device:
                    results[name][-1].update(
                        {"timed_by": "device", "events_ms": events_ms[0],
                         "plain_events_ms": events_ms[1]})
                if k == 1 and core:
                    results[name][-1].update(
                        {"timed_by": "its own launches", "core_fwd_ms": core["fwd"],
                         "core_bwd_ms": core["bwd"], "core_bound_ms": core_bound})
    return results


# -- phase 3c: the attention kernels of the head_dim 16 configuration ------------


def attention_work(entries: int, seq: int, d: int, dt: str, backward: bool,
                   stats: bool = True):
    """(FLOPs, bytes) of attention over (entries, seq, d): the QK^T and PV
    products forward (4 seq^2 d per entry), the five products of the
    backward (10 seq^2 d); q, k, v read and o written once (backward: q, k,
    v, dout read and dq, dk, dv written, plus with `stats` the float32 lse
    and delta, which small_attention's backward recomputes)."""
    size = 2 if dt == "bf16" else 4
    rows = entries * seq * d * size
    if backward:
        return 10 * entries * seq * seq * d, 7 * rows + stats * 2 * entries * seq * 4
    return 4 * entries * seq * seq * d, 4 * rows


def qkv_grads(fn, qkv, cot):
    """Output and dq, dk, dv of sum(fn(q, k, v) * cot)."""
    import torch

    q, k, v = (t.detach().clone().requires_grad_(True) for t in qkv)
    out = fn(q, k, v)
    torch.autograd.backward(out, (cot.to(out.dtype),))
    return [out.detach(), q.grad, k.grad, v.grad]


def qkv_fwd_bwd_ms(fn, qkv, cot, reps: int, warmup: int = 3) -> tuple[float, float]:
    """Median forward time with the autograd graph built, and median backward
    time on a retained graph."""
    import torch

    inputs = [t.detach().clone().requires_grad_(True) for t in qkv]
    fwd = median_ms(lambda: fn(*inputs), reps, warmup)
    out = fn(*inputs)
    bwd = median_ms(lambda: torch.autograd.grad(out, inputs, cot.to(out.dtype),
                                                retain_graph=True), reps, warmup)
    return fwd, bwd


def attention_cases():
    """(kernel names, description, kernel, plain version, (entries, seq, D),
    heads, rate, training) of phase 3c: eval cases first (one forward name),
    then training cases (forward and backward names)."""
    from beat_this_tpu_torch.ops import flash_attention as flash_ops
    from beat_this_tpu_torch.ops import small_attention as small_ops

    flash = (flash_ops.flash_attention, flash_ops.flash_attention_ref)
    small = (small_ops.small_attention, small_ops.small_attention_ref)
    for per_crop, seq, heads in H16_FLASH:
        yield (("flash_attention_fwd",), *flash, (per_crop * EVAL_CHUNKS, seq, H16), heads, 0.0,
               False)
    for per_crop, seq, heads in H16_SMALL:
        yield (("small_attention_fwd",), *small, (per_crop * EVAL_CHUNKS, seq, H16), heads, 0.0,
               False)
    for (per_crop, seq, heads), rates in zip(H16_FLASH, ((0.0, 0.2), (0.1,))):
        for rate in rates:
            yield (("flash_attention_fwd_lse", "flash_attention_bwd"), *flash,
                   (per_crop * TRAIN_CROPS, seq, H16), heads, rate, True)
    for rate in (0.0, 0.1):  # head_dim 32 at the flash ablation's shape
        yield (("flash_attention_fwd_lse", "flash_attention_bwd"), *flash, ABLATE_FLASH, 1, rate,
               True)
    for per_crop, seq, heads in H16_SMALL:
        for rate in (0.0, 0.1):
            yield (("small_attention_fwd", "small_attention_bwd"), *small,
                   (per_crop * TRAIN_CROPS, seq, H16), heads, rate, True)
    yield (("small_attention_fwd", "small_attention_bwd"), *small, SMALL_D32, 1, 0.1, True)


def qkv_device_ms(fn, qkv, cot, reps: int = 10) -> tuple[float, float]:
    """Device time of a forward (with the autograd graph built) and of a
    backward on a retained graph (call_device_ms)."""
    import torch

    inputs = [t.detach().clone().requires_grad_(True) for t in qkv]
    out, cot = fn(*inputs), cot.to(qkv[0].dtype)
    return (call_device_ms(lambda: fn(*inputs), reps),
            call_device_ms(lambda: torch.autograd.grad(out, inputs, cot, retain_graph=True),
                           reps))


def phase_attention_kernels(smi: str, only: tuple = ()) -> dict:
    """flash_attention and small_attention against their plain versions at
    the h16 model's shapes, on the same inputs, seed and cotangent: the
    output (eval) or the output and dq, dk, dv (training); median times of
    the kernel, the plain version and one `scaled_dot_product_attention`
    call on rotated q and k (the library's time for the same function,
    used on no path). small_attention's cases, whose kernels take a few
    microseconds against the host's tens around each call, are timed by
    device time (call_device_ms), with the events around the call beside
    them. `only`: the kernel names whose cases run (all when empty)."""
    import torch
    import torch.nn.functional as F

    from beat_this_tpu_torch.ops.rotary import apply_rope, rope_tables

    dev = torch.device(DEVICE)
    results = {name: [] for name in ATTN_KERNELS}
    for dtype, limit in ((torch.float32, F32_LIMIT), (torch.bfloat16, BF16_LIMIT)):
        dt = "f32" if dtype == torch.float32 else "bf16"
        for i, (names, kernel, plain, shape, heads, rate, training) in enumerate(
                attention_cases()):
            if only and not set(names) & set(only):
                continue
            entries, seq, d = shape
            gen = torch.Generator(device=dev).manual_seed(100 + 2 * i + (dtype == torch.float32))
            qkv = [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3)]
            cot = torch.randn(shape, generator=gen, device=dev)
            cos, sin = rope_tables(seq, d, dev)
            # the library call takes (batch, heads, seq, d): at most 8 entries as its
            # heads, the rest as its batch
            lib_shape = (entries // 8, 8, seq, d)
            lib_in = [t.reshape(lib_shape) for t in
                      (apply_rope(qkv[0], cos, sin), apply_rope(qkv[1], cos, sin), qkv[2])]

            def run(fn, q, k, v):
                return fn(q, k, v, cos, sin, rate, 41, heads)

            def library(q, k, v):
                return F.scaled_dot_product_attention(q, k, v, dropout_p=rate)

            if training:
                got = qkv_grads(lambda *t: run(kernel, *t), qkv, cot)
                want = qkv_grads(lambda *t: run(plain, *t), qkv, cot)
            else:
                with torch.inference_mode():
                    got, want = [run(kernel, *qkv)], [run(plain, *qkv)]
            torch.cuda.synchronize()
            devs = {g: rel_dev(a, b) for g, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
            abs_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
            finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
            del got, want
            if training:
                slow = rate > 0.0 and seq >= 512  # the plain version's torch Philox: seconds
                ms = qkv_fwd_bwd_ms(lambda *t: run(kernel, *t), qkv, cot, 10)
                plain_ms = qkv_fwd_bwd_ms(lambda *t: run(plain, *t), qkv, cot,
                                          2 if slow else 5, 1 if slow else 3)
                lib_ms = qkv_fwd_bwd_ms(library, lib_in, cot.reshape(lib_shape), 10)
            else:
                with torch.inference_mode():
                    ms = (median_ms(lambda: run(kernel, *qkv)),)
                    plain_ms = (median_ms(lambda: run(plain, *qkv), 5),)
                    lib_ms = (median_ms(lambda: library(*lib_in)),)
            by_device = names[0].startswith("small")
            events = (ms, plain_ms, lib_ms)
            if by_device:
                if training:
                    ms = qkv_device_ms(lambda *t: run(kernel, *t), qkv, cot)
                    plain_ms = qkv_device_ms(lambda *t: run(plain, *t), qkv, cot, 5)
                    lib_ms = qkv_device_ms(library, lib_in, cot.reshape(lib_shape))
                else:
                    with torch.inference_mode():
                        ms = (call_device_ms(lambda: run(kernel, *qkv)),)
                        plain_ms = (call_device_ms(lambda: run(plain, *qkv), 5),)
                        lib_ms = (call_device_ms(lambda: library(*lib_in)),)
            torch.cuda.empty_cache()
            worst = max(devs.values())
            ok = finite and (worst <= limit if dtype == torch.float32 else worst < limit)
            bounds = [bound(*attention_work(entries, seq, d, dt, k == 1,
                                            not name.startswith("small")),
                            "f32 split" if dt == "f32" and name in SPLIT_F32 else dt)
                      for k, name in enumerate(names)]
            desc = f"rate {rate} x ({entries}, {seq}, {d}) heads {heads}"
            print(f"[attention-kernels] {' + '.join(names)} {dt} {desc}: rel max dev "
                  + " ".join(f"{g} {v:.2e}" for g, v in devs.items()) + f" (limit {limit:g}); "
                  + "; ".join(
                      f"{name} kernel {ms[k]:.3f} ms plain {plain_ms[k]:.3f} ms library "
                      f"{lib_ms[k]:.3f} ms bound {bounds[k][0]:.3f} ms ({bounds[k][1]})"
                      + (f" (device time; events around the call: kernel {events[0][k]:.3f} "
                         f"plain {events[1][k]:.3f} library {events[2][k]:.3f})"
                         if by_device else "")
                      for k, name in enumerate(names))
                  + f" [{smi}] {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"{names[0]} {dt} {desc}: deviation {worst:.3e} over {limit:g}"
                      f" or non-finite ({devs})")
            for k, name in enumerate(names):
                results[name].append({
                    "case": f"{dt} {desc}", "rel_max_dev": worst, "max_abs_err": abs_err,
                    "ms": ms[k], "plain_ms": plain_ms[k], "bound_ms": bounds[k][0],
                    "bound_by": bounds[k][1], "library_ms": lib_ms[k]})
                if by_device:
                    results[name][-1].update({"timed_by": "device", "events_ms": events[0][k],
                                              "plain_events_ms": events[1][k],
                                              "library_events_ms": events[2][k]})
    return results


# -- phase 3d: the ablation kernels and the bench entry points ------------------------


def freq_stage_work(stage: str, rows: int, c: int, f_bins: int, size: int):
    """(FLOPs, bytes) of the frequency block cut at `stage`: the products up
    to there, x read and out written once, the stage's weights read once."""
    per_row = {"copy": 0, "rms": 0, "qkv": 6 * c * c, "ff": 16 * c * c,
               "attn": 8 * c * c + 4 * f_bins * c,
               "full": 8 * c * c + 4 * f_bins * c + 16 * c * c}[stage]
    weights = {"copy": 0, "rms": 0, "qkv": 3 * c * c, "ff": 8 * c * c, "attn": 4 * c * c,
               "full": 12 * c * c}[stage]
    return rows * per_row, (2 * rows * c + weights) * size


def phase_ablation_kernels(smi: str, only: tuple = ()) -> tuple[dict, dict]:
    """Every stage, mode, variant and pass of the bench kernels against its
    plain version on the card at the benches' full sizes (bfloat16, then
    float32; the standalone passes float32), with median times (B13's by
    device time); then the three entry points through `main()` at default
    flags. `only`: the kernel names whose cases run, without the entry
    points (all when empty). Returns (results, the entry points' launches)."""
    import torch
    import torch.nn.functional as F

    from beat_this_tpu_torch.bench import flash_ablate, fused_freq_ablate, softmax_variants
    from beat_this_tpu_torch.ops.fused_freq import fused_freq_roformer

    dev = torch.device(DEVICE)
    results = {name: [] for name in ABLATION_KERNELS}

    def want(name):
        return not only or name in only

    def record(name, desc, got, want, limit, kernel, plain, work, dt, library=None, note="",
               headline=False, split=False, device=None, library_device=False):
        """Holds one case, times it and appends it to `results[name]`; the
        first `headline` case of a kernel stands for it on the `kernels`
        line. `library`: one PyTorch call that computes the same function;
        `split`: the case's float32 products run as split bf16 products;
        `device`: the kernel timed by the device time of its launch whose
        name holds it (`kernel_device_ms`, not the wrapper's host time and
        casts), plain by events as always, the library call by events or,
        with `library_device`, by the device time of its one launch."""
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), f"{name} {desc}: non-finite")
        dev_rel = rel_dev(got, want)
        abs_err = float((got.float() - want.float()).abs().max())
        ms = kernel_device_ms(kernel, device) if device else median_ms(kernel)
        plain_ms = median_ms(plain, 5)
        lib_ms = (None if library is None else kernel_device_ms(library, "")
                  if library_device else median_ms(library))
        note += (" (kernel by device time)" if device else "") + (
            " (library by device time)" if library_device else "")
        split = split or name in SPLIT_F32
        bound_ms, bound_by = bound(*work, "f32 split" if dt == "f32" and split else dt)
        ok = dev_rel <= limit if dt == "f32" else dev_rel < limit
        print(f"[ablation-kernels] {name} {dt} {desc}: rel max dev {dev_rel:.3e} (limit "
              f"{limit:g}){note}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound {bound_ms:.3f} ms "
              f"({bound_by}) [{smi}] {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name} {dt} {desc}: deviation {dev_rel:.3e} over {limit:g}")
        headline = headline and not any(r["headline"] for r in results[name])
        results[name].append({"case": f"{dt} {desc}", "rel_max_dev": dev_rel,
                              "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                              "headline": headline})

    for dtype, limit, dt, size in ((torch.bfloat16, BF16_LIMIT, "bf16", 2),
                                   (torch.float32, F32_LIMIT, "f32", 4)):
        with torch.inference_mode():
            # B13: the frequency block cut after each stage, 16 chunks of 1500 frames
            rng = np.random.RandomState(0)
            items = ABLATE_BATCH * 1500
            for c, f_bins in fused_freq_ablate.SHAPES if want("freq_ablate") else ():
                x, params, (cos, sin) = fused_freq_ablate.make_case(rng, c, f_bins, items, dev,
                                                                    dtype)
                stage_ms = {}
                for stage in fused_freq_ablate.STAGES:
                    def kernel(st=stage):
                        return fused_freq_ablate.ablate_stage(x, params, st, cos, sin)

                    def plain(st=stage):
                        return fused_freq_ablate.ablate_stage_ref(x, params, st, cos, sin)

                    got = kernel()
                    if stage == "full":
                        check(torch.equal(got, fused_freq_roformer(x, *params, cos, sin)),
                              f"freq_ablate full C={c} {dt}: not the bits of fused_freq_roformer")
                    library = None  # one call only for the first two stages
                    if stage == "copy":
                        library = x.clone
                    elif stage == "rms" and hasattr(F, "rms_norm"):
                        gamma = params[0].norm.gamma.to(dtype)

                        def library(gamma=gamma, c=c):
                            return F.rms_norm(x, (c,), gamma, 1e-24)
                    # every stage with products runs K3's code, its float32 products split;
                    # the stage's kernel by its device time (events around a call hold the
                    # wrapper's host time, longer than copy's kernel)
                    record("freq_ablate", f"{stage} C={c} F={f_bins} items={items}", got,
                           plain(), limit, kernel, plain,
                           freq_stage_work(stage, items * f_bins, c, f_bins, size), dt, library,
                           headline=stage == "full", split=stage not in ("copy", "rms"),
                           device="freq_")
                    stage_ms[stage] = results["freq_ablate"][-1]["ms"]
                # the cuts of one kernel: its attention and its FF, each with the tile's
                # round trip, add up to the whole block, each at the block's blocks per SM
                # (not read from an older package, as `phase_on_tree.py` may run)
                blocks = ({st: fused_freq_ablate.blocks_per_sm(c, st, dtype)
                           for st in fused_freq_ablate.STAGES}
                          if hasattr(fused_freq_ablate, "blocks_per_sm") else {})
                print(f"[ablation-kernels] freq_ablate {dt} C={c}: attn + ff - copy = "
                      f"{stage_ms['attn'] + stage_ms['ff'] - stage_ms['copy']:.3f} ms, full "
                      f"{stage_ms['full']:.3f} ms (device time); blocks per SM "
                      f"{' '.join(f'{st} {n}' for st, n in blocks.items()) or 'not read'} "
                      f"[{smi}]", flush=True)
                check(len(set(blocks.values())) <= 1,
                      f"freq_ablate {dt} C={c}: blocks per SM differ from full's: {blocks}")
                del x, params
            torch.cuda.empty_cache()

            # B14: the flash forward with parts left out
            bh, n, d = ABLATE_FLASH
            q, k, v, cos, sin = flash_ablate.make_inputs(bh, n, d, dev, dtype)
            lib_shape = (bh // 8, 8, n, d)
            work = (4 * bh * n * n * d, 4 * bh * n * d * size)
            for mode in flash_ablate.MODES if want("flash_ablate") else ():
                def kernel(md=mode):
                    return flash_ablate.flash_variant(q, k, v, cos, sin, md,
                                                      flash_ablate.BLOCK_K)

                def plain(md=mode):
                    return flash_ablate.flash_variant_ref(q, k, v, cos, sin, md,
                                                          flash_ablate.BLOCK_K)

                got, want_o, note = kernel(), plain(), ""
                if mode == "noexp":
                    # o = acc / l with l = sum(s), which crosses zero: where |l| is small, the
                    # order of a float32 sum of 1536 scores moves o by percents on either
                    # side. The denominators and the numerators o * l (each side with its
                    # own l) are held on every row, o where |l| >= 1.
                    got, den = flash_ablate.flash_variant(
                        q, k, v, cos, sin, mode, flash_ablate.BLOCK_K, with_denominator=True)
                    want_o, want_den = flash_ablate.flash_variant_ref(
                        q, k, v, cos, sin, mode, flash_ablate.BLOCK_K, with_denominator=True)
                    den_dev = float((den - want_den).abs().max() / want_den.abs().max())
                    check(den_dev <= F32_LIMIT,
                          f"flash_ablate noexp {dt}: denominators deviate {den_dev:.3e}")
                    num_dev = rel_dev(got.float() * den[..., None],
                                      want_o.float() * want_den[..., None])
                    check(num_dev <= limit if dt == "f32" else num_dev < limit,
                          f"flash_ablate noexp {dt}: numerators deviate {num_dev:.3e}")
                    keep = want_den.abs() >= 1.0
                    note = (f", on the {int(keep.sum())} of {keep.numel()} rows with |l| >= 1; "
                            f"on every row denominators rel max dev {den_dev:.3e}, numerators "
                            f"{num_dev:.3e}")
                    got, want_o = got[keep], want_o[keep]
                library = None
                if mode == "full":  # cos = 1, sin = 0: q and k are their own rotations
                    def library():
                        return F.scaled_dot_product_attention(
                            q.reshape(lib_shape), k.reshape(lib_shape), v.reshape(lib_shape))
                record("flash_ablate", f"{mode} ({bh}, {n}, {d}) block_k {flash_ablate.BLOCK_K}",
                       got, want_o, limit, kernel, plain, work, dt, library, note,
                       mode == "full")
            del q, k, v
            torch.cuda.empty_cache()

            # B15a: the softmax pass variants at the model's two geometries
            rng = np.random.RandomState(0)
            n = softmax_variants.N_PAD
            mask, mask_col = softmax_variants.make_masks(n, softmax_variants.N_VALID, dev)
            for name, items, gh in (softmax_variants.GEOMETRIES
                                    if want("softmax_variants") else ()):
                q, k, v = softmax_variants.make_qkv(rng, items, n, gh, dev, dtype)
                for var in softmax_variants.VARIANTS:
                    def kernel(vr=var):
                        return softmax_variants.attention_variant(q, k, v, mask, vr, gh,
                                                                  mask_col)

                    def plain(vr=var):
                        return softmax_variants.attention_variant_ref(q, k, v, mask, vr, gh,
                                                                      mask_col)

                    # the PV product's column of ones is tmxusum's l too
                    qk_cols, pv_cols = 33 if var in softmax_variants.FOLDED else 32, 33
                    work = (2 * n * n * (qk_cols + pv_cols) * items * gh,
                            4 * items * n * gh * 32 * size)
                    library = None
                    if var == "full":
                        lib_mask = mask.to(dtype)[None, None, None, :]

                        def split(t):
                            return t.reshape(items, n, gh, 32).transpose(1, 2)

                        def library():
                            return F.scaled_dot_product_attention(
                                split(q), split(k), split(v), attn_mask=lib_mask, scale=1.0)
                    record("softmax_variants", f"{var} {items} items x {gh} heads n={n}",
                           kernel(), plain(), limit, kernel, plain, work, dt, library,
                           headline=var == "full")
                del q, k, v
            torch.cuda.empty_cache()

    with torch.inference_mode():
        # B15b: one pass alone over a score-sized float32 array
        rows, out_cols = softmax_variants.PASS_ROWS, softmax_variants.PASS_OUT_COLS
        rng, n = np.random.RandomState(0), softmax_variants.N_PAD
        x = torch.from_numpy((rng.rand(rows, n) * 2 - 1).astype(np.float32)).to(dev)
        for op in softmax_variants.PASSES if want("softmax_passes") else ():
            def kernel(o=op):
                return softmax_variants.softmax_pass(x, o, out_cols)

            def plain(o=op):
                return softmax_variants.softmax_pass_ref(x, o, out_cols)

            library = {"exp2": lambda: torch.exp2(x[:, :out_cols]),
                       "rowmax": lambda: x.amax(1, keepdim=True).expand(-1, out_cols),
                       "rowsum": lambda: x.sum(1, keepdim=True).expand(-1, out_cols)}[op]
            check(rel_dev(library(), plain()) <= F32_LIMIT,
                  f"softmax_passes {op}: the library call computes another function")
            note = ""
            if op == "exp2":
                # torch.exp2(x[:, :128]) reads 1/12 of x; torch.exp2(x) reads what the
                # kernel reads (and writes all of it)
                check(rel_dev(torch.exp2(x)[:, :out_cols], plain()) <= F32_LIMIT,
                      "softmax_passes exp2: torch.exp2(x) computes another function")
                whole = kernel_device_ms(lambda: torch.exp2(x), "")
                note = (f"; library over the kept columns only, torch.exp2(x[:, :{out_cols}]), "
                        f"reads 1/{n // out_cols} of x; torch.exp2(x) over all of it "
                        f"{whole:.3f} ms (device time)")
            record("softmax_passes", f"{op} ({rows}, {n}) -> {out_cols} columns", kernel(),
                   plain(), F32_LIMIT, kernel, plain, (rows * n, 4 * rows * (n + out_cols)), "f32",
                   library, note, headline=op == "exp2", device="softmax_pass_kernel",
                   library_device=True)
        del x
        torch.cuda.empty_cache()

    if only:
        return results, {}
    # the entry points at default flags: per timed variant 3 warm-ups and
    # `reps` windows of one launch
    wrappers = {"freq_ablate": fused_freq_ablate.ablate_stage,
                "flash_ablate": flash_ablate.flash_variant,
                "softmax_variants": softmax_variants.attention_variant,
                "softmax_passes": softmax_variants.softmax_pass}
    for fn in wrappers.values():
        fn.launches = 0
    for module in (fused_freq_ablate, flash_ablate, softmax_variants):
        t0 = time.perf_counter()
        module.main([])
        torch.cuda.synchronize()
        print(f"[ablation-kernels] {module.__name__}.main([]): {time.perf_counter() - t0:.1f} s",
              flush=True)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expect = {
        "freq_ablate": len(fused_freq_ablate.SHAPES) * len(fused_freq_ablate.STAGES) * (3 + 10),
        "flash_ablate": len(flash_ablate.MODES) * (3 + 10),
        "softmax_variants": (len(softmax_variants.GEOMETRIES) * len(softmax_variants.VARIANTS)
                             * (3 + 4)),
        "softmax_passes": len(softmax_variants.PASSES) * (3 + 4),
    }
    print(f"[ablation-kernels] launches of the three entry points: {launches}")
    check(launches == expect, f"bench entry points: launches {launches}, expected {expect}")
    return results, launches


# -- phase 5: training end to end --------------------------------------------


def phase_train(smi: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        return _train(Path(tmp), smi)


# phase 5's training runs: (name, partial transformers, precision, head_dim).
# The stock configuration in both precisions; --no-partial-transformers cut
# to float32; the head_dim 16 configuration in both precisions
TRAIN_RUNS = (("no-partial", False, "float32", 32), ("stock", True, "float32", 32),
              ("stock", True, "bfloat16", 32), ("h16", True, "float32", H16),
              ("h16", True, "bfloat16", H16), ("d256", True, "float32", 32))
# the "d256" run: another main width (8 heads), cut to 2 layers and 2 steps
D256_ARGS = ["--transformer-dim", "256", "--n-layers", "2", "--max-steps", "2",
             "--max-epochs", "2"]


def expected_train_launches(partial: bool, head_dim: int, layers: int = TRAIN_LAYERS,
                            steps: int = TRAIN_STEPS, accum: int = TRAIN_ACCUM) -> dict:
    """Launches of each training kernel over one run: per microbatch one
    attention and one feed-forward per time block (6 main layers, 3 frontend
    blocks with partial transformers) and one fused call per frequency
    block; at head_dim 16 the fused attention kernels decline every block,
    so each time block's attention is flash_attention, each frequency
    block small_attention plus a feed-forward of its own."""
    per_step = accum * steps
    frontend = FRONTEND_BLOCKS if partial else 0
    time_blocks = (layers + frontend) * per_step
    freq_blocks = frontend * per_step
    fused = head_dim == 32
    attn = {"fused_time_attention_train": time_blocks if fused else 0,
            "fused_freq_roformer_train": freq_blocks if fused else 0,
            "fused_ff_train": time_blocks + (0 if fused else freq_blocks)}
    expect = {f"{k}_{d}": v for k, v in attn.items() for d in ("fwd", "bwd")}
    expect.update({"flash_attention_fwd_lse": 0 if fused else time_blocks,
                   "flash_attention_bwd": 0 if fused else time_blocks,
                   "small_attention_fwd": 0 if fused else freq_blocks,
                   "small_attention_bwd": 0 if fused else freq_blocks})
    return expect


def _train_args(root: Path, name: str, partial: bool, precision: str) -> list:
    tag = f"{name}-{precision}"
    return ["--data-dir", str(root / "data"), "--checkpoint-dir", str(root / f"ckpt-{tag}"),
            "--partial-transformers" if partial else "--no-partial-transformers",
            "--batch-size", "8", "--train-length", "1500",
            "--accumulate-grad-batches", str(TRAIN_ACCUM), "--warmup-steps", "1",
            "--max-steps", str(TRAIN_STEPS), "--max-epochs", str(TRAIN_STEPS),
            "--val-frequency", "1", "--precision", precision, "--no-tempo-augmentation",
            "--no-pitch-augmentation", "--no-mask-augmentation", "--num-workers", "4",
            "--log-file", str(root / f"log-{tag}.jsonl"), "--device", DEVICE]


def step_grads(trainer, tc, batch, seeds, kernels: bool):
    """(losses, gradients, buffers) of one accumulated step from the
    trainer's initial weights."""
    from beat_this_tpu_torch.train.task import accumulate_grads

    model = trainer.init_state().model
    parts = accumulate_grads(model, tc, batch, seeds, kernels=kernels)
    return ({k: float(v) for k, v in parts.items()},
            {k: p.grad for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()})


def make_trainer(args, head_dim: int, **kwargs):
    """(trainer, data module, train config) for the training command's
    arguments `args` at `head_dim` (the command itself fixes 32)."""
    from beat_this_tpu_torch.data import BeatDataModule
    from beat_this_tpu_torch.model.beat_this import BeatThisConfig
    from beat_this_tpu_torch.train.task import TrainConfig
    from beat_this_tpu_torch.train.trainer import Trainer

    dm = BeatDataModule(Path(args.data_dir), batch_size=args.batch_size,
                        train_length=args.train_length, num_workers=args.num_workers,
                        augmentations={}, length_based_oversampling_factor=0.65, seed=args.seed)
    dm.setup("fit")
    pw = dm.get_train_positive_weights(widen_target_mask=3)
    tc = TrainConfig(warmup_steps=args.warmup_steps, accum_steps=args.accumulate_grad_batches,
                     pos_weight_beat=pw["beat"], pos_weight_downbeat=pw["downbeat"],
                     compute_dtype=args.precision, max_steps=args.max_steps)
    cfg = BeatThisConfig(transformer_dim=args.transformer_dim, n_layers=args.n_layers,
                         head_dim=head_dim, dropout_frontend=args.frontend_dropout,
                         dropout_transformer=args.transformer_dropout,
                         partial_transformers=args.partial_transformers)
    return Trainer(cfg, tc, dm, seed=args.seed, device=args.device, **kwargs), dm, tc


@contextlib.contextmanager
def pooled_frames(record: Optional[list] = None, replay: Optional[list] = None):
    """Inside, the training losses' max-pool (`train/loss.py:max_pool_valid`)
    appends the frame each pooled window picks to `record`, or takes its
    frames in call order from `replay` (the same windows, recorded on
    another path), with max_pool1d's gradient routing."""
    import torch.nn.functional as F

    from beat_this_tpu_torch.train import loss as loss_mod

    def pool(x, window):
        flat = x.reshape(-1, x.shape[-1])
        if replay is None:
            out, frames = F.max_pool1d(flat[:, None], window, stride=1, return_indices=True)
            record.append(frames[:, 0])
            out = out[:, 0]
        else:
            out = flat.gather(-1, replay[len(used)])
            used.append(None)
        return out.reshape(x.shape[:-1] + (out.shape[-1],))

    used: list = []
    orig = loss_mod.max_pool_valid
    loss_mod.max_pool_valid = pool
    try:
        yield
    finally:
        loss_mod.max_pool_valid = orig
    check(replay is None or len(used) == len(replay), "pooled windows replayed out of step")


# gradients whose distance from the float32 plain path first_step_check prints in
# bfloat16 also when within the limit: the gate bias of the first frontend time
# block, the gradient nearest its 2x limit (ROADMAP C6)
WATCHED_GRADS = ("frontend.blocks.0.partial.attnT.to_gates.bias",)


def first_step_check(args, head_dim: int = 32) -> tuple[float, float, int]:
    """The first step's losses, gradients and batch-norm statistics on the
    kernel path against the plain path, from the training run's first batch and
    dropout seeds; then the kernel and plain step times (host clock around
    a synchronized train_step) and the peak device memory of a kernel step.

    In bfloat16 two kinds of gradient are dominated by rounding on either
    path, so that each bfloat16 path is as far from the float32 one as from
    the other: with the shift-tolerant loss, the max-pool turns near-ties of
    the logits into different argmax frames; and in the frontend a
    train-mode batch norm follows every block, so the gradient entering it
    sums to zero over the rows, and the parameters just before it (the FF
    output biases of the partial transformers) get sums over 96k-384k rows
    that nearly cancel. So in bfloat16, under the training loss and under
    a max-pool-free loss (`weighted_bce`): the loss and the statistics are
    held to the limit, and so is every gradient of the main transformer
    layers; any other gradient over the limit must be no farther from the
    float32 plain path than twice the bfloat16 plain path's own distance
    from it (a kernel fault moves the kernel path away from float32, while
    rounding moves both paths alike).

    In float32 the max-pool's near-ties flip too, at logits that differ by
    float rounding between any two implementations (the h16 model's first
    step: 2 of 95,424 pooled windows; PERF.md, Findings, PR 9), and the
    frontend biases above amplify one flipped window to ~2e-3. So in float32
    the kernel path takes the plain path's pooled frames wherever the two
    differ (`pooled_frames`), and every gradient is held to the limit on that
    common routing; the count of such windows is printed."""
    import dataclasses

    import torch

    from beat_this_tpu_torch.train.task import make_optimizer, make_scheduler, train_step

    trainer, dm, tc = make_trainer(args, head_dim)
    batch = trainer._to_device(next(dm.train_batches(tc.accum_steps, seed=args.seed)))
    gen = torch.Generator().manual_seed((args.seed & 0xFFFFFFFF) << 32)
    seeds = torch.randint(0, 2**31 - 1, (tc.accum_steps,), generator=gen).tolist()
    bf16 = args.precision == "bfloat16"
    limit = BF16_LIMIT if bf16 else F32_LIMIT

    def within(v: float) -> bool:
        return v < limit if bf16 else v <= limit

    losses = [tc.loss_type] + (["weighted_bce"] if bf16 else [])
    for loss_type in losses:
        ltc = dataclasses.replace(tc, loss_type=loss_type)
        plain_frames, kernel_frames = [], []
        with pooled_frames(record=plain_frames):
            want, w_grads, w_bufs = step_grads(trainer, ltc, batch, seeds, False)
        with pooled_frames(record=kernel_frames):
            got, g_grads, g_bufs = step_grads(trainer, ltc, batch, seeds, True)
        flips = sum(int((a != b).sum()) for a, b in zip(kernel_frames, plain_frames))
        if flips and not bf16:
            devs = sorted((rel_dev(g_grads[k], w_grads[k]) for k in g_grads), reverse=True)
            print(f"[train] first step {args.precision}, {loss_type}: {flips} of "
                  f"{sum(f.numel() for f in plain_frames)} pooled windows pick another frame on "
                  f"the kernel path (largest gradient deviation {devs[0]:.2e}); the kernel "
                  "path again on the plain path's frames")
            with pooled_frames(replay=plain_frames):
                got, g_grads, g_bufs = step_grads(trainer, ltc, batch, seeds, True)
        devs = sorted(((rel_dev(g_grads[k], w_grads[k]), k) for k in g_grads), reverse=True)
        loss = max(abs(got[k] - want[k]) / abs(want[k]) for k in got)
        bn = max(rel_dev(g_bufs[k], w_bufs[k]) for k in g_bufs)
        over = [k for d, k in devs if not within(d)]
        print(f"[train] first step {args.precision}, {loss_type}, kernel vs plain path, same "
              f"batch and dropout seeds: losses {got['total']:.6f} / {want['total']:.6f} (rel "
              f"{loss:.2e}), batch-norm statistics {bn:.2e}; largest gradient deviations "
              + ", ".join(f"{k} {d:.2e}" for d, k in devs[:4])
              + f"; {len(devs) - len(over)} of {len(devs)} gradients within {limit:g}")
        check(within(max(loss, bn)), f"first step {args.precision} {loss_type}: loss or "
                                     "batch-norm statistics deviate")
        check(bf16 or not over, f"first step {args.precision}: gradients {over} deviate")
        shown = over + [k for k in WATCHED_GRADS if bf16 and k in g_grads and k not in over]
        if shown:
            ref = step_grads(trainer, dataclasses.replace(ltc, compute_dtype="float32"), batch,
                             seeds, False)[1]
            dev_of = {k: d for d, k in devs}
            far = {k: (rel_dev(g_grads[k], ref[k]), rel_dev(w_grads[k], ref[k])) for k in shown}
            del ref
            for k, (kern, plain) in far.items():
                print(f"[train]   {k}: kernel vs plain {dev_of[k]:.2e}; from the float32 "
                      f"plain path: kernel path {kern:.2e}, plain path {plain:.2e}, ratio "
                      f"{kern / plain:.2f}x (limit 2x where over {limit:g})")
        if over:
            main_layers = [k for k in over if k.startswith("transformer_blocks.")]
            check(not main_layers, f"first step {args.precision} {loss_type}: main-layer "
                                   f"gradients {main_layers} deviate")
            bad = [k for k in over if far[k][0] > 2 * far[k][1]]
            check(not bad, f"first step {args.precision} {loss_type}: {bad} farther from "
                           "float32 than twice the plain path")
        del g_grads, w_grads

    def timed(model, kernels: bool, reps: int) -> list:
        opt = make_optimizer(model, tc)
        sched = make_scheduler(opt, tc)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, opt, sched, batch, gen, tc, kernels=kernels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernel_times = timed(trainer.init_state().model, True, 4)
    peak = torch.cuda.max_memory_allocated()
    # one plain step at head_dim 16: its torch Philox masks over (n, n) scores take
    # tens of seconds
    plain_times = timed(trainer.init_state().model, False, 2 if head_dim == 32 else 1)
    return statistics.median(kernel_times[1:]), plain_times[-1], peak


def _train(root: Path, smi: str) -> dict:
    import torch

    from beat_this_tpu_torch import cli
    from beat_this_tpu_torch.data.synth import write_click_corpus
    from beat_this_tpu_torch.inference import load_model
    from beat_this_tpu_torch.train.__main__ import get_parser, main

    write_click_corpus(root / "data", n_pieces=16, n_val_pieces=2, frames=3000, seed=0)
    print("[train] click corpus: 16 training and 2 validation pieces of 3000 frames; reduced: "
          f"{TRAIN_ACCUM} microbatches per step (reference 8), {TRAIN_STEPS} steps, "
          "augmentations off (the corpus has no pitch- or tempo-shifted spectrograms)")
    print("[train] reduced: the --no-partial-transformers run in float32 only; the stock and "
          "the head_dim 16 configuration in float32 and bfloat16 (head_dim 16 through the "
          "Trainer class, validated once after its counted steps)")
    counters = train_counters()
    launches = {}
    wav = root / "piece.wav"
    write_wav(wav, 601, 7)
    for name, partial, precision, head_dim in TRAIN_RUNS:
        extra = D256_ARGS if name == "d256" else []
        args = get_parser().parse_args(_train_args(root, name, partial, precision) + extra)
        expect = expected_train_launches(partial, head_dim, args.n_layers, args.max_steps)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        if head_dim == 32:
            state = main(args)
        else:
            # the command line fixes head_dim 32: the class it wraps, without validation
            # inside the counted run (its eval forward launches small_attention too)
            trainer = make_trainer(
                args, head_dim, max_epochs=args.max_epochs, val_frequency=TRAIN_STEPS + 1,
                checkpoint_dir=Path(args.checkpoint_dir), name=name, log_file=args.log_file)[0]
            state = trainer.fit(max_steps_override=args.max_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {k: fn.launches for k, fn in counters.items()}
        launches = {k: launches.get(k, 0) + v for k, v in run.items()}
        if head_dim != 32:
            trainer.validate(state, TRAIN_STEPS)
        tag = f"{name} {precision}"
        print(f"[train] training run {tag}: {state.step} steps in {wall:.1f} s wall (set-up, "
              f"validation and checkpoints included), launches {run}")
        check(state.step == args.max_steps, f"{tag}: {state.step} steps")
        for k, v in run.items():
            check(v == expect[k], f"{tag}: {k} launched {v} times, expected {expect[k]}")
        records = [json.loads(line) for line in Path(args.log_file).read_text().splitlines()]
        losses = [r[k] for r in records for k in r if k.startswith(("train_loss", "val_loss"))]
        check(len(losses) > 0 and all(np.isfinite(losses)), f"{tag}: losses {losses}")
        print(f"[train] {tag}: logged losses {[round(v, 4) for v in losses]}")
        ckpt = next(Path(args.checkpoint_dir).glob("*.ckpt"))
        model = load_model(ckpt, args.device)
        check(model.config.partial_transformers == partial
              and model.config.head_dim == head_dim, f"{tag}: checkpoint config")
        out = root / f"piece-{name}-{precision}.beats"
        cli.run([str(wav)], str(ckpt), str(out), ".beats", False, False, False, False,
                0 if DEVICE == "cuda" else -1, precision == "bfloat16", False)
        check(out.exists(), f"{tag}: the CLI wrote no .beats file")
        print(f"[train] {tag}: checkpoint {ckpt.name} ({ckpt.stat().st_size} bytes) loads "
              f"through load_model; the CLI wrote {out.name} with "
              f"{len(out.read_text().splitlines())} beats")
        step_s, plain_s, peak = first_step_check(args, head_dim)
        print(f"[train] step time {tag}, transformer {args.transformer_dim} x {args.n_layers}, "
              f"batch 8 x 1500, {TRAIN_ACCUM} "
              f"microbatches, dropout {args.frontend_dropout} / {args.transformer_dropout}: "
              f"kernel path {step_s:.3f} s, plain path {plain_s:.3f} s [{smi}]")
        print(f"[train] torch.cuda.max_memory_allocated over kernel-path steps {tag}: "
              f"{peak / 2**30:.2f} GiB [{smi}]", flush=True)
    return launches


# -- phase 6: the launch-script drivers -------------------------------------


def phase_drivers(smi: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_drivers_") as tmp:
        return _drivers(Path(tmp), smi)


# phase 6's overfit runs at full width (BeatThisConfig(), h16 with head_dim 16):
# (name, head_dim, precision); the corpus (4 + 1 pieces of 700 frames, batch
# 4: one step an epoch) and the 512-frame crops as launch_scripts/overfit_smoke.py,
# its epochs and learning rate not: at its 45 and 1e-3 the stock model marks
# every other beat (mean F beat 0.42-0.44) on the kernel path and on the plain path
# alike (bench/overfit_paths.py; PERF.md, Findings)
OVERFIT_RUNS = (("stock", 32, "float32"), ("stock", 32, "bfloat16"), ("h16", H16, "bfloat16"))
OVERFIT_EPOCHS, OVERFIT_LR = 60, 4e-4
# launches of one eval forward of the four 700-frame training pieces (one masked
# 768-frame bucket): the time blocks' feed-forwards through K1 and, stock, the
# frequency blocks through K3 (the masked time blocks' attention is plain, as in
# the JAX package); h16 as in phase 4's short piece
SCORING_LAUNCHES = {32: {"fused_ff": 9, "fused_freq_roformer": 3},
                    H16: {k: v for k, v in H16_EVAL_LAUNCHES["short"].items() if v}}
# the raw wavs of the preprocessing run: (name, sample rate, seconds)
RAW_WAVS = (("clicks_a", 22050, 8.0), ("clicks_b", 44100, 12.0), ("clicks_c", 22050, 20.0))


def driver_counters() -> dict:
    """Every main-path kernel wrapper with its `launches` count: the
    training kernels and the eval kernels."""
    from beat_this_tpu_torch.ops.flash_attention import flash_fwd
    from beat_this_tpu_torch.ops.fused_ff import fused_ff
    from beat_this_tpu_torch.ops.fused_freq import fused_freq_roformer
    from beat_this_tpu_torch.ops.fused_time import fused_time_roformer

    return {**train_counters(), "fused_ff": fused_ff, "fused_time_roformer": fused_time_roformer,
            "fused_freq_roformer": fused_freq_roformer, "flash_attention_fwd": flash_fwd}


def _drivers(root: Path, smi: str) -> dict:
    """preprocess_audio over raw click wavs; overfit_smoke at full width (stock
    float32 and bfloat16, h16 bfloat16); clean_checkpoints on the stock float32
    run's checkpoint; compute_paper_metrics on the cleaned one (minimal and
    --dbn). Returns the launches of all of it."""
    import torch

    from beat_this_tpu_torch import clean_checkpoints, compute_paper_metrics
    from beat_this_tpu_torch.inference import ChunkedPredictor, load_model
    from beat_this_tpu_torch.model import BeatThisConfig
    from beat_this_tpu_torch.overfit_smoke import overfit

    counters = driver_counters()
    launches = dict.fromkeys(counters, 0)

    def delta(before: dict) -> dict:
        return {k: fn.launches - before[k] for k, fn in counters.items() if fn.launches > before[k]}

    _preprocess(root / "prep", smi)
    epochs, lr = OVERFIT_EPOCHS, OVERFIT_LR
    for name, head_dim, precision in OVERFIT_RUNS:
        tag = f"{name} {precision}"
        work = root / f"overfit-{name}-{precision}"
        start = {k: fn.launches for k, fn in counters.items()}
        scoring = {}
        predict_many = ChunkedPredictor.predict_many

        def scored(self, spects):  # the counts when the scoring starts
            scoring.setdefault("start", {k: fn.launches for k, fn in counters.items()})
            return predict_many(self, spects)

        ChunkedPredictor.predict_many = scored
        config = BeatThisConfig(head_dim=head_dim)
        t0 = time.perf_counter()
        try:
            report = overfit(config, epochs=epochs, lr=lr,
                             compute_dtype=precision, out=root / f"{name}-{precision}.json",
                             workdir=work, device=DEVICE)
        finally:
            ChunkedPredictor.predict_many = predict_many
        wall = time.perf_counter() - t0
        train, score = delta(start), delta(scoring["start"])
        train = {k: v - score.get(k, 0) for k, v in train.items() if v > score.get(k, 0)}
        curve = [r["train_loss_total"] for r in report["curve"]]
        print(f"[drivers] overfit_smoke {tag}, BeatThisConfig(head_dim={head_dim}) "
              f"({config.transformer_dim} x {config.n_layers}), "
              f"{epochs} epochs of one step (batch 4 x 512 frames), lr {lr:g}: {wall:.1f} s wall "
              f"(fit {report['fit_s']} s, a checkpoint an epoch), loss {curve[0]:.4f} -> "
              f"{curve[-1]:.4f}, mean F beat {report['mean_f_beat']} / downbeat "
              f"{report['mean_f_downbeat']} (per piece {report['f_measure_beat']} / "
              f"{report['f_measure_downbeat']}); launches training {train}, scoring {score} "
              f"[{smi}]", flush=True)
        want = {k: v for k, v in expected_train_launches(True, head_dim, steps=epochs,
                                                          accum=1).items() if v}
        check(train == want, f"overfit {tag}: training launches {train}, expected {want}")
        check(score == SCORING_LAUNCHES[head_dim],
              f"overfit {tag}: scoring launches {score}, expected {SCORING_LAUNCHES[head_dim]}")
        check(len(curve) == epochs and curve[-1] < 0.5 * curve[0], f"overfit {tag}: loss {curve}")
        check(report["ok"], f"overfit {tag}: mean F {report['mean_f_beat']} / "
                            f"{report['mean_f_downbeat']} under 0.95 / 0.90")
        for k, v in delta(start).items():
            launches[k] += v
        if (name, precision) == ("stock", "float32"):  # the checkpoint the next drivers read
            ckpt, f_beat, data = work / "ckpts" / "overfit-S0.ckpt", report["f_measure_beat"], work

    t0 = time.perf_counter()
    clean_checkpoints.main(clean_checkpoints.get_parser().parse_args([str(ckpt), "--suffix"]))
    cleaned = ckpt.with_suffix(".cleaned.ckpt")
    kept = sorted(torch.load(cleaned, weights_only=True))
    check(kept == sorted(clean_checkpoints.KEEP_KEYS), f"cleaned checkpoint keys {kept}")
    load_model(cleaned, DEVICE)
    print(f"[drivers] clean_checkpoints on the stock float32 run's checkpoint: "
          f"{ckpt.stat().st_size} -> {cleaned.stat().st_size} bytes, keys {kept}, loads through "
          f"load_model ({time.perf_counter() - t0:.1f} s)")

    calls = []
    compute = compute_paper_metrics.compute_predictions

    def recorded(*args, **kwargs):  # the per-piece metrics main prints only as means
        calls.append(compute(*args, **kwargs))
        return calls[-1]

    compute_paper_metrics.compute_predictions = recorded
    try:
        for dbn in ([], ["--dbn"]):
            start = {k: fn.launches for k, fn in counters.items()}
            t0 = time.perf_counter()
            compute_paper_metrics.main(compute_paper_metrics.get_parser().parse_args(
                ["--models", str(cleaned), "--datasplit", "train", "--data-dir", str(data),
                 "--device", DEVICE] + dbn))
            wall = time.perf_counter() - t0
            run = delta(start)
            metrics, _, _, pieces = calls[-1]
            per_piece = [round(float(f), 4) for f in metrics["F-measure_beat"]]
            print(f"[drivers] compute_paper_metrics {' '.join(dbn) or 'minimal'} on the cleaned "
                  f"checkpoint, train split ({len(pieces)} pieces): {wall:.1f} s wall, F beat "
                  f"{per_piece}, downbeat "
                  f"{[round(float(f), 4) for f in metrics['F-measure_downbeat']]}, CMLt "
                  f"{float(np.mean(metrics['CMLt_beat'])):.4f}, AMLt "
                  f"{float(np.mean(metrics['AMLt_beat'])):.4f}; launches {run} [{smi}]")
            check(run == SCORING_LAUNCHES[32], f"compute_paper_metrics: launches {run}")
            if not dbn:
                check(per_piece == f_beat, f"compute_paper_metrics: per-piece F {per_piece}, "
                                           f"the overfit run's {f_beat}")
            check(bool(np.all(np.isfinite(metrics["F-measure_beat"]))), "metrics not finite")
            for k, v in run.items():
                launches[k] += v
    finally:
        compute_paper_metrics.compute_predictions = compute
    return {k: v for k, v in launches.items() if v}


def _preprocess(root: Path, smi: str) -> None:
    """preprocess_audio's three stages over RAW_WAVS (beats every 0.5 s) with one
    pitch and one tempo variant; its spectrograms against the port's own log-mel
    of the mono wavs on the CPU, within float16 rounding."""
    import torch

    from beat_this_tpu_torch import preprocess_audio
    from beat_this_tpu_torch.data import MemmappedNpz
    from beat_this_tpu_torch.io.audio import load_audio, save_wav
    from beat_this_tpu_torch.ops.mel import log_mel_spectrogram

    raw = root / "raw"
    raw.mkdir(parents=True)
    beats = root / "data" / "annotations" / "clicks" / "annotations" / "beats"
    beats.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for name, sr, seconds in RAW_WAVS:
        t = np.arange(int(sr * seconds)) / sr
        x = 0.05 * rng.standard_normal(len(t)) + 0.5 * np.sin(2 * np.pi * 1000 * t) * (
            (t % 0.5) < 0.02)
        save_wav(raw / f"{name}.wav", x, sr)
        times = np.arange(0.0, seconds - 0.1, 0.5)
        np.savetxt(beats / f"{name}.beats", np.stack([times, np.arange(len(times)) % 4 + 1], 1),
                   fmt="%.3f\t%d")
    (root / "audio_paths.tsv").write_text(f"clicks,{raw}\n")
    base = preprocess_audio.BASEPATH
    preprocess_audio.BASEPATH = root
    t0 = time.perf_counter()
    try:
        preprocess_audio.main(preprocess_audio.get_parser().parse_args(
            ["--audio-paths", str(root / "audio_paths.tsv"), "--stage", "all", "--pitch-shift",
             "1", "1", "--time-stretch", "4", "9", "--device", DEVICE]))
    finally:
        preprocess_audio.BASEPATH = base
    wall = time.perf_counter() - t0
    npz = MemmappedNpz(root / "data" / "audio" / "spectrograms" / "clicks.npz")
    want = sorted(f"{name}/{v}" for name, _, _ in RAW_WAVS for v in ("track", "track_ps1",
                                                                     "track_ts-4"))
    check(sorted(npz) == want, f"preprocess_audio: npz members {sorted(npz)}")
    worst = 0.0
    for key in want:
        wav = root / "data" / "audio" / "mono_tracks" / "clicks" / f"{key}.wav"
        x, sr = load_audio(wav, dtype="float32")
        check(sr == 22050, f"{wav.name}: {sr} Hz")
        ref = log_mel_spectrogram(torch.from_numpy(x)).numpy().astype(np.float16)
        got = np.asarray(npz[key])
        check(got.shape == ref.shape and got.dtype == np.float16, f"{key}: {got.shape}")
        step = np.spacing(np.maximum(np.abs(got), np.abs(ref)))
        err = np.abs(got.astype(np.float32) - ref.astype(np.float32)) / step.astype(np.float32)
        worst = max(worst, float(err.max()))
    print(f"[drivers] preprocess_audio --stage all over {len(RAW_WAVS)} raw wavs "
          f"({', '.join(f'{sr} Hz {s:g} s' for _, sr, s in RAW_WAVS)}), pitch +1, tempo -4%: "
          f"{wall:.1f} s wall, {len(want)} spectrograms in clicks.npz; the card's against the "
          f"CPU log-mel: at most {worst:g} float16 steps apart [{smi}]")
    check(worst <= 1.0, f"preprocess_audio: spectrograms {worst} float16 steps off the CPU's")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    try:
        import beat_this_tpu_torch
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 1
    if Path(beat_this_tpu_torch.__file__).resolve().parent.parent != here:
        print("chip_smoke: imported a beat_this_tpu_torch from elsewhere", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    try:
        smi = timed("environment", phase_environment)
        timed("build", phase_build)
        results = timed("kernels", phase_kernels, smi)
        results.update(timed("train-kernels", phase_train_kernels, smi))
        results.update(timed("attention-kernels", phase_attention_kernels, smi))
        ablation, bench_launches = timed("ablation-kernels", phase_ablation_kernels, smi)
        results.update(ablation)
        launches = timed("end-to-end", phase_end_to_end, smi)
        launches.update(bench_launches)
        for k, v in timed("train", phase_train, smi).items():
            launches[k] = launches.get(k, 0) + v  # small_attention_fwd runs on both paths
        for k, v in timed("drivers", phase_drivers, smi).items():
            launches[k] = launches.get(k, 0) + v
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "beat_this_tpu") or m.startswith(("jax.", "beat_this_tpu.")))
        check(not bad, f"imported {bad}")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    summary = []
    for name, (source, replaces) in KERNELS.items():
        # the first float32 case (rate 0 for training); an ablation kernel's `full` case
        main_case = next((r for r in results[name] if r.get("headline")), results[name][0])
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results[name]),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            # no single PyTorch call computes a fused roformer block, its
            # gated attention branch or its FF residual: only the attention
            # kernels and the standalone passes have a library time
            "library_ms": main_case.get("library_ms"),
            "cases": results[name],
        })
    print(f"[summary] {smi}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
