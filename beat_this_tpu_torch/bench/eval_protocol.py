"""The whole evaluation protocol of `compute_paper_metrics` on the card,
timed, on a click corpus with a briefly trained checkpoint.

    python -m beat_this_tpu_torch.bench.eval_protocol [--pieces 64] [--frames 2800]
        [--fixture-steps 150] [--random-weights] [--device cuda] [--out FILE]

Counterpart of tools/bench_eval_protocol_tpu.py: everything
`compute_paper_metrics` does per piece, not only the forward: the data module's iteration over a
GTZAN-layout corpus (`data.synth.write_click_corpus`: spectrograms with
bursts at the annotated beats), batched chunked inference in bf16 with
stitching and batched postprocessing (`predict_postprocess_batched`), and
per-piece metrics. The checkpoint is the gate's fixture
(`check_all._flagship_trained`, the full-width model trained on click
batches through the training kernels) after `--fixture-steps` steps,
enough for the beat logits to cross the postprocessor's 0 threshold, so the
mean beat F-measure is near 1.0 and the timing doubles as a check of the
protocol; `--random-weights` times the plumbing on an untrained model (F is
noise) over a corpus without bursts. Two full passes: the first cold, the
second warm (host clock). Prints its lines, then one JSON line.
`main(argv, sizes)` takes a smaller `check_all.Geometry` for the fixture in
tests; the command line trains it at full width.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from pathlib import Path

import torch

from beat_this_tpu_torch.bench.timing import bench_device, device_line, seed_model


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.bench.eval_protocol",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--pieces", type=int, default=64)
    parser.add_argument("--frames", type=int, default=2800)
    parser.add_argument("--random-weights", action="store_true",
                        help="skip the fixture's training steps; F will be noise")
    parser.add_argument("--fixture-steps", type=int, default=150,
                        help="optimizer steps of the trained fixture: enough for the beat "
                             "logits to cross the postprocessor's 0 threshold")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--out", default=None, help="also write the JSON record here")
    return parser


def main(argv=None, sizes=None) -> dict:
    """`sizes`: the fixture's `check_all.Geometry` (default: full width)."""
    from beat_this_tpu_torch.check_all import FULL, _flagship_trained
    from beat_this_tpu_torch.compute_paper_metrics import datamodule_setup
    from beat_this_tpu_torch.data.synth import write_click_corpus
    from beat_this_tpu_torch.inference import (
        ChunkedPredictor,
        model_from_checkpoint,
        predict_postprocess_batched,
    )
    from beat_this_tpu_torch.io.checkpoint import load_checkpoint
    from beat_this_tpu_torch.metrics import Metrics
    from beat_this_tpu_torch.postprocessing import Postprocessor

    args = get_parser().parse_args(argv)
    device = bench_device(args.device)
    print(device_line(device))
    geo = sizes or FULL
    config = geo.config
    record = {}
    if args.random_weights:
        model = seed_model(config, device)
    else:
        t0 = time.perf_counter()
        fixture = _flagship_trained(geo, device, args.fixture_steps)
        model, curve = fixture["model"], fixture["curve"]
        record["fixture_train_s"] = round(time.perf_counter() - t0, 2)
        print(f"trained fixture: loss {curve[0]:.4f} -> {curve[-1]:.4f} over {len(curve)} "
              f"steps ({record['fixture_train_s']} s)", flush=True)
    with tempfile.TemporaryDirectory(prefix="evalproto-") as tmp:
        root = Path(tmp) / "data"
        write_click_corpus(root, n_pieces=args.pieces, n_val_pieces=0, frames=args.frames,
                           dataset="gtzan", beat_gain=0.0 if args.random_weights else 6.0)
        ckpt = Path(tmp) / "fixture.ckpt"
        torch.save({"state_dict": {"model." + k: v.cpu() for k, v in model.state_dict().items()},
                    "hyper_parameters": dataclasses.asdict(config),
                    "datamodule_hyper_parameters": {"batch_size": 8, "test_dataset": "gtzan"}},
                   ckpt)
        checkpoint = load_checkpoint(str(ckpt))
        predictor = ChunkedPredictor(model_from_checkpoint(checkpoint, device),
                                     compute_dtype=torch.bfloat16)
        postprocessor = Postprocessor("minimal", fps=50, device=device)
        metrics = Metrics(eval_trim_beats=5)

        def one_pass():
            datamodule = datamodule_setup(checkpoint, 2, "test", root)
            n, f_sum, audio_s = 0, 0.0, 0.0
            for piece, beat, _ in predict_postprocess_batched(
                    predictor, postprocessor, datamodule.predict_pieces()):
                f_sum += float(metrics(piece["truth_orig_beat"], beat, step="test")["F-measure"])
                audio_s += len(piece["spect"]) / 50.0
                n += 1
            return n, f_sum / max(n, 1), audio_s

        t0 = time.perf_counter()
        one_pass()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        n, f_mean, audio_s = one_pass()
        warm = time.perf_counter() - t0
    key = "mean_f_beat_randomweights" if args.random_weights else "mean_f_beat_trained"
    print(f"{n} pieces, {audio_s:.1f} s: cold pass {cold:.3f} s, warm pass {warm:.3f} s "
          f"({audio_s / warm:.1f}x realtime, {n / warm:.2f} pieces/s); {key} {f_mean:.4f}")
    record = {
        "pieces": n,
        "audio_seconds": round(audio_s, 1),
        "warm_protocol_s": round(warm, 4),
        "pieces_per_s": round(n / warm, 3),
        "audio_x_realtime": round(audio_s / warm, 2),
        "cold_protocol_s": round(cold, 4),
        key: round(f_mean, 4),
        **record,
    }
    if not args.random_weights:
        record["fixture_steps"] = args.fixture_steps
    print(json.dumps(record), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=2) + "\n")
    return record


if __name__ == "__main__":
    main()
