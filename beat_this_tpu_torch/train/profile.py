"""Where the time of one training step goes on the card:

    python -m beat_this_tpu_torch.train.profile [--no-partial-transformers]
        [--precision float32|bfloat16] [--head-dim 16|32]

Trains the full-width model (`init_beat_this(0)`) for two warm-up steps on
a click corpus written by `data.synth` into a temporary directory (batch 8
x 1500 frames, 2 microbatches, the default dropout of
`python -m beat_this_tpu_torch.train`), then runs one more `train_step` under
`torch.profiler` and prints, beside the card's `nvidia-smi` name and power
limit: the step's wall time (host clock around a synchronized step), the
device's summed kernel time and busy share (kernel time over wall), the
step's peak device memory (`torch.cuda.max_memory_allocated`), the device
time of each kernel entry's `bt.<entry>` range (`profiler.range_device_ms`:
a kernel counts for the entry that launched it, so B7's feed-forward half
counts for B7, not B9) and of the rest, and the kernels by device time,
grouped by the port's kernel families (B4/B5
`fused_time_train.cu`, B6 `fused_freq.cu`, B7 `fused_freq_train.cu`, B8/B9
`ff_train.cuh`, whose B9 families also hold B7's feed-forward half, run by
the same kernels; the shared operand conversions; at `--head-dim 16`, where
the fused attention kernels decline every block, B10/B11
`flash_attention.cu` (with its pre-pass of rotation and operand parts) and B12
`small_attention.cu`) and everything else (cuBLAS, cuDNN, elementwise,
optimizer). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from collections import defaultdict
from pathlib import Path

from beat_this_tpu_torch import profiler

BATCH, LENGTH, ACCUM = 8, 1500, 2  # crops per microbatch, frames per crop, microbatches
WARMUP, TOP = 2, 12  # unprofiled steps first; kernels listed by name

# kernel-name fragments -> the family they belong to, first match wins
FAMILIES = (
    ("freq_rows_kernel", "B7 rows (norm, g, gates)"),
    ("freq_qkv_kernel", "B7 qkv (RoPE epilogue)"),
    ("freq_core_fwd", "B7 attention core, recomputed"),
    ("freq_out_kernel", "B7 out projection (x2)"),
    ("freq_dattn", "B7 d_attn"),
    ("freq_dog", "B7 d_og"),
    ("freq_core_bwd", "B7 attention core backward"),
    ("freq_product_kernel<false", "B7 d_g"),
    ("freq_product_kernel<true", "B7 dW_qkv, dW_out"),
    ("freq_post", "B7 post"),
    ("freq_sums", "B7 sums"),
    ("freq_block_kernel", "B6 fused_freq (train fwd, tensor cores)"),
    ("fused_freq_kernel", "B6 fused_freq (train fwd)"),
    ("time_rows_kernel", "B4 time_qkv: rows (norm, gates)"),
    ("time_qkv", "B4 time_qkv: q/k/v product"),
    ("operands_kernel", "operands (B4/B5/B7/B8/B9 weights; B5 f32 split q, k, v)"),
    ("attn_fwd_kernel", "B4 attn_fwd"),
    ("attn_out_kernel", "B4 attn_out"),
    ("attn_bwd_pre", "B5 pre (d_branch, gated rows)"),
    ("attn_dgo", "B5 d_go"),
    ("attn_dkv_kernel", "B5 dq, dk, dv (one pass)"),
    ("attn_product_kernel<false", "B5 d_gn"),
    ("attn_product_kernel<true", "B5 dW_qkv, dW_out"),
    ("attn_bwd_post", "B5 post"),
    ("attn_bwd_sums", "B5 sums"),
    ("ff_hidden_kernel<3, false>", "B8 hidden"),
    ("ff_hidden_kernel<1, false>", "B8 hidden"),
    ("ff_out_kernel", "B8 out"),
    ("ff_pre_kernel", "B8/B9 pre (row passes)"),
    ("ff_hidden_kernel", "B9 hidden (pre1, d_h1)"),
    ("ff_product_kernel<false", "B9 d_g"),
    ("ff_product_kernel<true", "B9 dW1, dW2"),
    ("ff_post_kernel", "B9 post"),
    ("column_sums", "B9 column_sums"),
    ("rotate_kernel", "B10/B11 pre-pass (rotation, operand parts)"),
    ("flash_fwd", "B10 flash_fwd"),
    ("flash_dq", "B11 flash_dq"),
    ("flash_dkv", "B11 flash_dkv"),
    ("small_fwd", "B12 small_fwd"),
    ("small_bwd", "B12 small_bwd"),
)


def family(name: str) -> str:
    for frag, fam in FAMILIES:
        if frag in name:
            return fam
    return "other (cuBLAS, cuDNN, elementwise, optimizer, copies)"


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.train.profile")
    p.add_argument("--partial-transformers", default=True, action=argparse.BooleanOptionalAction)
    p.add_argument("--precision", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--head-dim", type=int, default=32, choices=[16, 32])
    return p


def main(argv=None) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from beat_this_tpu_torch.data import BeatDataModule
    from beat_this_tpu_torch.data.synth import write_click_corpus
    from beat_this_tpu_torch.bench.timing import nvidia_smi_line, seed_model
    from beat_this_tpu_torch.model.beat_this import BeatThisConfig
    from beat_this_tpu_torch.train.task import (
        TrainConfig,
        make_optimizer,
        make_scheduler,
        train_step,
    )

    args = get_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    smi = nvidia_smi_line()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="beat_this_profile_") as tmp:
        write_click_corpus(Path(tmp), n_pieces=16, n_val_pieces=2, frames=3000, seed=0)
        dm = BeatDataModule(Path(tmp), batch_size=BATCH, train_length=LENGTH, num_workers=2,
                            augmentations={}, length_based_oversampling_factor=0.65, seed=0)
        dm.setup("fit")
        pw = dm.get_train_positive_weights(widen_target_mask=3)
        batch = next(dm.train_batches(ACCUM, seed=0))
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in batch.items() if isinstance(v, np.ndarray)}
    cfg = BeatThisConfig(partial_transformers=args.partial_transformers,
                         head_dim=args.head_dim)
    tc = TrainConfig(warmup_steps=1, accum_steps=ACCUM,
                     pos_weight_beat=pw["beat"], pos_weight_downbeat=pw["downbeat"],
                     compute_dtype=args.precision, max_steps=100)
    model = seed_model(cfg, dev)
    opt, gen = make_optimizer(model, tc), torch.Generator().manual_seed(0)
    sched = make_scheduler(opt, tc)
    for _ in range(WARMUP):
        train_step(model, opt, sched, batch, gen, tc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, sched, batch, gen, tc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    by_name: dict[str, float] = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            by_name[evt.name] += evt.device_time_total / 1e3  # us -> ms
    by_family: dict[str, float] = defaultdict(float)
    for name, ms in by_name.items():
        by_family[family(name)] += ms
    device_ms = sum(by_name.values())
    ranges = profiler.range_device_ms(prof.events(), device_ms)
    config = "stock" if args.partial_transformers else "no-partial"
    if args.head_dim != 32:
        config += f", head_dim {args.head_dim}"
    print(f"[profile] {smi}")
    print(f"[profile] one train_step, {config} config, {args.precision}, full width, batch "
          f"{BATCH} x {LENGTH}, {ACCUM} microbatches: wall {1e3 * wall:.1f} ms, device kernel "
          f"time {device_ms:.1f} ms, busy share {device_ms / (1e3 * wall):.3f}, peak device "
          f"memory {peak_gib:.2f} GiB")
    for entry, ms in sorted(ranges.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {entry}: {ms:.1f} ms ({ms / device_ms:.1%})")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"[profile]     {fam}: {ms:.1f} ms ({ms / device_ms:.1%})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"[profile]   kernel {name[:90]}: {ms:.2f} ms")
    return {"wall_ms": 1e3 * wall, "device_ms": device_ms, "peak_gib": peak_gib,
            "ranges": ranges, "families": dict(by_family)}


if __name__ == "__main__":
    main()
