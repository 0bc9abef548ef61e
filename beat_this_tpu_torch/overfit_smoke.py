"""Trainer learning proof on the card: overfit a synthetic click-track corpus
with the real `Trainer.fit` and score the training pieces through the full
inference and postprocessing path, counterpart of
launch_scripts/overfit_smoke.py.

On CUDA every training step runs the hand-written training kernels (the
time-axis attention branch, the frequency block and the feed-forward, or at
head_dim 16 flash_attention and small_attention) with their dropout, and the
scoring runs the eval kernels; a wrong backward cannot reach F-measure ~1.0
on beats and downbeats. On the CPU (`--device cpu`) the same runs through the
kernels' plain versions.

Writes a JSON report (default OVERFIT.json) with the loss curve and the
final F-measures, and leaves the trained checkpoint in the trainer's format
under `<workdir>/ckpts/`, where `compute_paper_metrics` and
`clean_checkpoints` read it. Exits 1 unless mean F beat >= 0.95 and mean F
downbeat >= 0.90.

    python -m beat_this_tpu_torch.overfit_smoke --out OVERFIT.json
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

F_BEAT_MIN, F_DOWNBEAT_MIN = 0.95, 0.90


def overfit(config, *, epochs: int = 45, train_length: int = 512, lr: float = 1e-3,
            compute_dtype: str = "float32", out="OVERFIT.json", workdir=None,
            device: str = "cuda") -> dict:
    """Train `config` (a `BeatThisConfig`) on a fresh click corpus under
    `workdir` (default: a new temporary directory), score the training
    pieces, write the report to `out` and return it."""
    import torch

    from beat_this_tpu_torch.data import BeatDataModule, BeatTrackingDataset
    from beat_this_tpu_torch.data.synth import write_click_corpus
    from beat_this_tpu_torch.inference import ChunkedPredictor, resolve_device
    from beat_this_tpu_torch.metrics import Metrics
    from beat_this_tpu_torch.postprocessing import Postprocessor
    from beat_this_tpu_torch.train.task import TrainConfig
    from beat_this_tpu_torch.train.trainer import Trainer

    device = resolve_device(device)
    platform = "gpu" if device.type == "cuda" else device.type
    kernels = device.type == "cuda"  # a CUDA tensor launches the kernels or raises
    print(f"platform={platform} cuda_kernels={kernels}")

    # pieces longer than the crop; crops of 512 frames route an h16 model's
    # time blocks through flash_attention (model/layers.py:FLASH_MIN_SEQ)
    root = Path(workdir or tempfile.mkdtemp(prefix="beat_this_overfit_"))
    train_items = write_click_corpus(
        root, n_pieces=4, n_val_pieces=1, frames=max(700, train_length + 100), beat_gain=6.0,
    )
    dm = BeatDataModule(root, batch_size=4, train_length=train_length, augmentations={},
                        test_dataset=None, seed=0)
    dm.setup("fit")
    pos_weights = dm.get_train_positive_weights(widen_target_mask=3)
    print("pos weights:", pos_weights)

    tc = TrainConfig(accum_steps=1, warmup_steps=5, lr=lr, compute_dtype=compute_dtype,
                     pos_weight_beat=pos_weights["beat"],
                     pos_weight_downbeat=pos_weights["downbeat"])
    trainer = Trainer(config, tc, dm, max_epochs=epochs, val_frequency=10**9,
                      checkpoint_dir=root / "ckpts", name="overfit", seed=0, device=device)
    t0 = time.time()
    state = trainer.fit()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fit_s = time.time() - t0

    predictor = ChunkedPredictor(state.model.eval())
    postp = Postprocessor("minimal", fps=50, device=predictor.device)
    metrics = Metrics(eval_trim_beats=5)
    full = BeatTrackingDataset(train_items, root, train_length=None, augmentations={},
                               deterministic=True)
    items = [full[i] for i in range(len(full))]
    results = predictor.predict_many([it["spect"] for it in items])
    f_beat, f_down = [], []
    for item, (beat_logits, down_logits) in zip(items, results):
        beat, down = postp(beat_logits, down_logits)
        f_beat.append(metrics(item["truth_orig_beat"], beat, step="val")["F-measure"])
        f_down.append(metrics(item["truth_orig_downbeat"], down, step="val")["F-measure"])

    curve = [{k: r[k] for k in ("epoch", "train_loss_total")}
             for r in trainer.history if "train_loss_total" in r]
    report = {
        "platform": platform,
        "cuda_kernels": kernels,
        "compute_dtype": compute_dtype,
        "transformer_dim": config.transformer_dim,
        "n_layers": config.n_layers,
        "epochs": epochs,
        "fit_s": round(fit_s, 1),
        "loss_first": curve[0]["train_loss_total"],
        "loss_last": curve[-1]["train_loss_total"],
        "f_measure_beat": [round(float(f), 4) for f in f_beat],
        "f_measure_downbeat": [round(float(f), 4) for f in f_down],
        "mean_f_beat": round(float(np.mean(f_beat)), 4),
        "mean_f_downbeat": round(float(np.mean(f_down)), 4),
        "ok": bool(np.mean(f_beat) >= F_BEAT_MIN and np.mean(f_down) >= F_DOWNBEAT_MIN),
        "curve": curve,
    }
    Path(out).write_text(json.dumps(report, indent=1) + "\n")
    print(f"fit {fit_s:.0f}s, mean F beat={report['mean_f_beat']} "
          f"downbeat={report['mean_f_downbeat']} -> ok={report['ok']} ({out})")
    return report


def main(args) -> int:
    from beat_this_tpu_torch.model.beat_this import BeatThisConfig

    config = BeatThisConfig(transformer_dim=args.transformer_dim, n_layers=args.n_layers)
    report = overfit(config, epochs=args.epochs, train_length=args.train_length, lr=args.lr,
                     compute_dtype=args.compute_dtype, out=args.out, workdir=args.workdir,
                     device=args.device)
    return 0 if report["ok"] else 1


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.overfit_smoke",
                                     description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=45)
    parser.add_argument("--transformer-dim", type=int, default=64)
    parser.add_argument("--n-layers", type=int, default=1)
    parser.add_argument("--train-length", type=int, default=512)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--out", default="OVERFIT.json")
    parser.add_argument("--workdir", default=None,
                        help="reuse a directory for the synthetic corpus (default: mkdtemp)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on, e.g. cuda, cuda:1 or cpu")
    return parser


if __name__ == "__main__":
    sys.exit(main(get_parser().parse_args()))
