"""Throughput of the batched DBN decoder on the card: audio seconds decoded
per second, with the beat F-measure of the decoded beats.

    python -m beat_this_tpu_torch.bench.dbn [--pieces 32] [--frames 3000]
        [--device cuda] [--out FILE]

Counterpart of tools/bench_dbn_tpu.py. `--pieces` click-activation pieces of
`--frames` + 64 (i mod 4) frames at 50 fps (a few lengths, like a test set),
beats every 20-28 frames (107-150 bpm), every fourth a downbeat, over a low
noise floor. `postprocessing.dbn.DbnDecoder(device=...).decode_many` decodes
them all at once (the Viterbi passes of both bar lengths on the device):
the first call cold, then the best of 3 warm calls (host clock; the decoder
returns host arrays). The beats are scored against the click construction
(`metrics.Metrics`, 5 s trim). Prints its lines, then one JSON line.
`main(argv, sizes)` takes smaller `Sizes` for tests; the command line runs
the default.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from beat_this_tpu_torch.bench.timing import bench_device, device_line


@dataclasses.dataclass(frozen=True)
class Sizes:
    reps: int = 3  # warm decodes


def click_activations(pieces: int, frames: int):
    """tools/bench_dbn_tpu.py's pieces: ((T, 2) beat / downbeat activations,
    beat times in seconds) each."""
    rng = np.random.RandomState(0)
    acts, truth = [], []
    for i in range(pieces):
        t = frames + 64 * (i % 4)
        act = np.full((t, 2), 0.02) + rng.uniform(0, 0.01, (t, 2))
        period = 20 + (i % 5) * 2
        beats = []
        for count, frame in enumerate(range(5 + (i % 7), t, period)):
            act[frame] = [0.02, 0.75] if count % 4 == 0 else [0.85, 0.02]
            beats.append(frame)
        acts.append(act)
        truth.append(np.asarray(beats) / 50.0)
    return acts, truth


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.bench.dbn",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--pieces", type=int, default=32)
    parser.add_argument("--frames", type=int, default=3000)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--out", default=None, help="also write the JSON record here")
    return parser


def main(argv=None, sizes: Sizes = Sizes()) -> dict:
    from beat_this_tpu_torch.metrics import Metrics
    from beat_this_tpu_torch.postprocessing.dbn import DbnDecoder

    args = get_parser().parse_args(argv)
    device = bench_device(args.device)
    print(device_line(device))
    pieces, truth = click_activations(args.pieces, args.frames)
    audio_s = sum(len(p) for p in pieces) / 50.0
    decoder = DbnDecoder(device=device)  # 3 and 4 beats per bar, 55-215 bpm
    t0 = time.perf_counter()
    outs = decoder.decode_many(pieces)
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(sizes.reps):
        t0 = time.perf_counter()
        outs = decoder.decode_many(pieces)
        warm.append(time.perf_counter() - t0)
    best = min(warm)
    metrics = Metrics(eval_trim_beats=5)
    f_beat = [metrics(t, out[:, 0], step="val")["F-measure"] for t, out in zip(truth, outs)]
    print(f"{args.pieces} pieces, {audio_s:.1f} s of activations: cold {cold:.3f} s, warm best "
          f"{best:.3f} s ({audio_s / best:.1f}x realtime); beat F against the clicks mean "
          f"{np.mean(f_beat):.4f}, min {np.min(f_beat):.4f}")
    record = {
        "pieces": args.pieces,
        "audio_seconds": round(audio_s, 1),
        "warm_decode_s": round(best, 4),
        "audio_x_realtime": round(audio_s / best, 2),
        "s_per_piece": round(best / args.pieces, 5),
        "mean_beats_per_piece": int(np.mean([len(o) for o in outs])),
        "mean_f_beat_clicks": round(float(np.mean(f_beat)), 4),
        "min_f_beat_clicks": round(float(np.min(f_beat)), 4),
        "cold_decode_s": round(cold, 4),
    }
    print(json.dumps(record), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=2) + "\n")
    return record


if __name__ == "__main__":
    main()
