"""The CLI's directory mode end to end on the card, and one group by stage.

    python -m beat_this_tpu_torch.bench.cli_dir [--files 32] [--dim 512] [--layers 6]
        [--device cuda] [--out FILE]

Counterpart of tools/bench_cli_dir_tpu.py: the `mel_stage` corpus (32 files,
11 minutes of audio, mixed lengths) written as 16-bit wavs, a checkpoint
of the full-width model (`init_beat_this(0)`), and two `cli.run` calls over
the directory with `--batch-files` equal to the file count: the first pays
the kernels' build and load, cuDNN's choices and the caches, the second is
warm. Then one warm group by stage, through the components `process_many`
composes (host clock around each stage and a synchronize of the card):

  load         decode, mono, resample (`BatchedFile2File._load_one`, threaded;
               a 16-bit mono wav at 22050 Hz stays int16)
  mel          the group's log-mel on the device (`_batched_spects_device`)
  forward      windows gathered on the device and the forwards, logits to
               the host (`predict_many_device`)
  postprocess  one batched postprocess (`frames2beats`)

beside the host path (`_batched_spects`: the log-mel downloaded and sliced,
then `predict_many`: the chunks uploaded again), whose logits the device
path must equal bit for bit. Prints its lines, then one JSON line.
`main(argv, sizes)` takes smaller `Sizes` for tests; the command line runs
the default. `bench/phase_on_tree.py cli-dir` runs the two `cli.run` calls
on another checkout's package and this one's in turns.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from beat_this_tpu_torch.bench.mel_stage import synth_corpus
from beat_this_tpu_torch.bench.timing import bench_device, device_line


@dataclasses.dataclass(frozen=True)
class Sizes:
    total_sec: float = 660.0  # audio seconds of the corpus before clipping


def write_inputs(tmp: Path, files: int, dim: int, layers: int, sizes: Sizes = Sizes()):
    """The corpus as 16-bit wavs in `tmp / "wavs"` and the seed-0 checkpoint
    `tmp / "m.ckpt"` of a `dim` x `layers` model; returns (wavs, checkpoint,
    audio seconds)."""
    from beat_this_tpu_torch.io.audio import save_wav
    from beat_this_tpu_torch.io.checkpoint import init_beat_this
    from beat_this_tpu_torch.model import BeatThisConfig

    wavs = tmp / "wavs"
    wavs.mkdir()
    sigs = synth_corpus(files, sizes.total_sec)
    for i, s in enumerate(sigs):
        save_wav(wavs / f"f{i:03d}.wav", s, 22050)
    config = BeatThisConfig(transformer_dim=dim, n_layers=layers)
    ckpt = tmp / "m.ckpt"
    torch.save({"state_dict": {"model." + k: v for k, v in init_beat_this(0, config).items()},
                "hyper_parameters": {"transformer_dim": dim, "n_layers": layers}}, ckpt)
    return wavs, ckpt, sum(len(s) for s in sigs) / 22050.0


def _timed(fn, device, runs: int = 2):
    """(result, seconds) of the last of `runs` calls of `fn`, each followed
    by a synchronize of the card: the first warms up."""
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    return out, seconds


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.bench.cli_dir",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--files", type=int, default=32)
    parser.add_argument("--dim", type=int, default=512, help="transformer_dim [%(default)s]")
    parser.add_argument("--layers", type=int, default=6, help="n_layers [%(default)s]")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--out", default=None, help="also write the JSON record here")
    return parser


def main(argv=None, sizes: Sizes = Sizes()) -> dict:
    from beat_this_tpu_torch import cli
    from beat_this_tpu_torch.inference import BatchedFile2File, _pad_logit_group

    args = get_parser().parse_args(argv)
    device = bench_device(args.device)
    print(device_line(device))
    with tempfile.TemporaryDirectory(prefix="bench_cli_dir_") as tmp:
        tmp = Path(tmp)
        wavs, ckpt, audio_s = write_inputs(tmp, args.files, args.dim, args.layers, sizes)
        print(f"corpus: {args.files} files, {audio_s:.1f} s audio, on disk; checkpoint "
              f"{args.dim} x {args.layers}")

        gpu = -1 if device.type == "cpu" else (device.index or 0)
        before = BatchedFile2File.host_groups

        def cli_once(out: Path) -> float:
            t0 = time.perf_counter()
            cli.run([str(wavs)], str(ckpt), str(out), ".beats", False, False, False, False, gpu,
                    False, False, batch_files=args.files)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return time.perf_counter() - t0

        cold = cli_once(tmp / "out_cold")
        warm = cli_once(tmp / "out_warm")
        n_out = len(list((tmp / "out_warm").glob("*.beats")))
        host_groups = BatchedFile2File.host_groups - before
        print(f"cli run 1 (cold): {cold:.3f} s; run 2 (warm): {warm:.3f} s, "
              f"{audio_s / warm:.1f}x realtime, {n_out} outputs, {host_groups} groups on the "
              f"host path")

        f2f = BatchedFile2File(ckpt, device, group_size=args.files)
        paths = sorted(wavs.glob("*.wav"))
        t0 = time.perf_counter()
        with ThreadPoolExecutor() as pool:
            signals = [s for s, _ in pool.map(f2f._load_one, paths)]
        load = time.perf_counter() - t0
        group, mel = _timed(lambda: f2f._batched_spects_device(signals), device)
        results, forward = _timed(lambda: f2f.predictor.predict_many_device(*group), device)
        _, post = _timed(lambda: f2f.frames2beats(*_pad_logit_group(results)), device)
        spects, host_mel = _timed(lambda: f2f._batched_spects(signals), device)
        host_results, host_forward = _timed(lambda: f2f.predictor.predict_many(spects), device)
        _, group_s = _timed(lambda: f2f._group_logits(signals), device)
        worst = max(max(float(np.abs(db - hb).max()), float(np.abs(dd - hd).max()))
                    for (db, dd), (hb, hd) in zip(results, host_results))
        print(f"staged (warm): load {load:.3f} s, mel {mel:.3f} s, forward {forward:.3f} s, "
              f"postprocess {post:.3f} s; signals -> logits {group_s:.3f} s on the device "
              f"path, {host_mel + host_forward:.3f} s on the host path (mel {host_mel:.3f} s "
              f"with its download, forward {host_forward:.3f} s with the chunks' upload)")
        print(f"device-vs-host logit agreement: max |d| = {worst:.3e}")
        assert worst == 0.0, "the device-resident path diverged from the host path"
        assert host_groups == 0 and n_out == args.files, (host_groups, n_out)
    record = {
        "files": args.files, "audio_seconds": round(audio_s, 3),
        "model": f"{args.dim}x{args.layers}",
        "cli_cold_s": round(cold, 4), "cli_warm_s": round(warm, 4),
        "cli_warm_x_realtime": round(audio_s / warm, 2), "host_path_groups": host_groups,
        "load_s": round(load, 4), "mel_s": round(mel, 4), "forward_s": round(forward, 4),
        "postprocess_s": round(post, 4), "group_logits_s": round(group_s, 4),
        "host_mel_s": round(host_mel, 4), "host_forward_s": round(host_forward, 4),
        "device_vs_host_max_abs": worst,
    }
    print(json.dumps(record), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=2) + "\n")
    return record


if __name__ == "__main__":
    main()
