"""The small model family on the card (transformer_dim 128, the reference's
`small0/1/2`, ~2M parameters): eval throughput and the training step.

    python -m beat_this_tpu_torch.bench.small [--device cuda] [--out FILE]

Counterpart of tools/bench_small_tpu.py, with `BeatThisConfig(transformer_dim=128)`
(4 heads: its time blocks through K2, its frequency blocks through K3, its
training through B4-B9 at widths the stock model also builds):

  eval   x realtime of bf16 forwards over 40 batches of 8 chunks of 1500
         frames (3 timed passes of 3 sweeps each after two warm sweeps; min
         and median), counting chunk_size - 2 * border frames of audio per
         chunk as the chunked path keeps them
  train  seconds per optimizer step of 8 microbatches of 8 crops of 1500
         frames, bf16, random targets (the reference's 8 x 8 x 1500): two
         warm steps, then 5 timed steps with new dropout seeds, min and
         median; and the peak device memory

Host clock around synchronized work. No share of the card's peak is given:
that waits for a FLOP model of the port. Prints its lines, then one JSON line.
`main(argv, sizes)` takes smaller `Sizes` for tests; the command line runs
the defaults.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from beat_this_tpu_torch.bench.timing import bench_device, device_line, seed_model

BORDER, FPS = 6, 50.0


@dataclasses.dataclass(frozen=True)
class Sizes:
    dim: int = 128  # transformer_dim: the small family
    layers: int = 6
    batches: int = 40  # eval batches
    chunks: int = 8  # chunks per eval batch
    frames: int = 1500  # frames per chunk and per training crop
    micro: int = 8  # crops per microbatch
    accum: int = 8  # microbatches per step
    steps: int = 5  # timed training steps


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def eval_x_realtime(model, device, batches: int, chunks: int, frames: int):
    """(best, median) x realtime of bf16 forwards over the batches."""
    xs = torch.from_numpy(np.random.RandomState(0).randn(batches, chunks, frames, 128)
                          .astype(np.float32)).to(device)

    def sweep():
        outs = []
        with torch.inference_mode():
            for x in xs:
                out = model(x, compute_dtype=torch.bfloat16)
                outs.append((out["beat"][:, 0], out["downbeat"][:, 0]))
        return outs

    for _ in range(2):
        sweep()
    _sync(device)
    iters, times = 3, []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            sweep()
        _sync(device)
        times.append(time.perf_counter() - t0)
    audio_s = iters * batches * chunks * (frames - 2 * BORDER) / FPS
    return audio_s / min(times), audio_s / statistics.median(times)


def train_step_s(config, device, micro: int, accum: int, frames: int, steps: int):
    """(min, median) seconds per optimizer step and the peak memory in GiB
    (None on the CPU), tools/bench_small_tpu.py's batch: random spectrogram
    and targets."""
    from beat_this_tpu_torch.train.task import (
        TrainConfig,
        make_optimizer,
        make_scheduler,
        train_step,
    )

    tc = TrainConfig(max_steps=100, accum_steps=accum, compute_dtype="bfloat16")
    model = seed_model(config, device)
    opt = make_optimizer(model, tc)
    sched = make_scheduler(opt, tc)
    rng = np.random.RandomState(1)
    batch = {
        "spect": rng.randn(accum, micro, frames, 128).astype(np.float32),
        "truth_beat": (rng.rand(accum, micro, frames) < 0.1).astype(np.float32),
        "truth_downbeat": (rng.rand(accum, micro, frames) < 0.03).astype(np.float32),
        "padding_mask": np.ones((accum, micro, frames), np.float32),
        "downbeat_mask": np.ones((accum, micro), np.float32),
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    for i in range(2):
        float(train_step(model, opt, sched, batch, torch.Generator().manual_seed(i), tc)["total"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        float(train_step(model, opt, sched, batch, torch.Generator().manual_seed(2 + i),
                         tc)["total"])
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    return min(times), statistics.median(times), peak


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.bench.small",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--out", default=None, help="also write the JSON record here")
    return parser


def main(argv=None, sizes: Sizes = Sizes()) -> dict:
    from beat_this_tpu_torch.model import BeatThisConfig

    args = get_parser().parse_args(argv)
    device = bench_device(args.device)
    print(device_line(device))
    config = BeatThisConfig(transformer_dim=sizes.dim, n_layers=sizes.layers)
    model = seed_model(config, device).eval().requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    best, median = eval_x_realtime(model, device, sizes.batches, sizes.chunks, sizes.frames)
    print(f"small ({sizes.dim} x {sizes.layers}, {n_params} parameters): eval bf16 {best:.1f}x "
          f"realtime (median {median:.1f}x) over {sizes.batches} batches of {sizes.chunks} x "
          f"{sizes.frames}", flush=True)
    step_min, step_median, peak = train_step_s(config, device, sizes.micro, sizes.accum,
                                               sizes.frames, sizes.steps)
    print(f"train step {sizes.accum} x {sizes.micro} x {sizes.frames} bf16: {step_min:.4f} s min, "
          f"{step_median:.4f} s median; peak memory "
          + (f"{peak:.2f} GiB" if peak is not None else "not measured"))
    record = {
        "model": f"small (transformer_dim={sizes.dim})",
        "params": n_params,
        "eval_x_realtime": round(best, 2),
        "eval_x_realtime_median": round(median, 2),
        "train_step_s": round(step_min, 4),
        "train_step_s_median": round(step_median, 4),
        "train_peak_gib": round(peak, 3) if peak is not None else None,
    }
    print(json.dumps(record), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=2) + "\n")
    return record


if __name__ == "__main__":
    main()
