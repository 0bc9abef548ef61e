"""Paper-metric evaluation driver of the PyTorch port, counterpart of
launch_scripts/compute_paper_metrics.py (reference
launch_scripts/compute_paper_metrics.py): rebuilds the data module from a
checkpoint's embedded `datamodule_hyper_parameters`, predicts full pieces
through the batched chunked-inference path (`predict_postprocess_batched`),
computes per-piece F-measure / Cemgil / CMLt / AMLt for beats and downbeats,
and aggregates overall and per dataset (one model), as mean +- std across
seeds, or as a k-fold concatenation with a duplicate-piece assertion.
`--dump-predictions` writes an npz of [time, beat_number] rows per piece.
Runs on the card unless `--device cpu` asks for the CPU.

    python -m beat_this_tpu_torch.compute_paper_metrics --models a.ckpt --datasplit test
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def datamodule_setup(checkpoint, num_workers, datasplit, data_dir):
    from beat_this_tpu_torch.data import BeatDataModule

    print("Creating datamodule")
    hparams = dict(checkpoint.get("datamodule_hyper_parameters", {}))
    hparams.pop("data_dir", None)
    # rename reference key for the test set
    if "test_dataset" not in hparams:
        hparams.setdefault("test_dataset", "gtzan")
    if num_workers is not None:
        hparams["num_workers"] = num_workers
    hparams["predict_datasplit"] = datasplit
    datamodule = BeatDataModule(data_dir, **hparams)
    datamodule.setup(stage="predict")
    return datamodule


def model_setup(checkpoint, eval_trim_beats, dbn, device="cuda"):
    from beat_this_tpu_torch.inference import ChunkedPredictor, model_from_checkpoint
    from beat_this_tpu_torch.metrics import Metrics
    from beat_this_tpu_torch.postprocessing import Postprocessor

    hparams = checkpoint.get("hyper_parameters", {})
    if eval_trim_beats is not None:
        hparams["eval_trim_beats"] = eval_trim_beats
    if dbn is not None:
        hparams["use_dbn"] = dbn
    predictor = ChunkedPredictor(model_from_checkpoint(checkpoint, device))
    postprocessor = Postprocessor(type="dbn" if hparams.get("use_dbn") else "minimal",
                                  fps=hparams.get("fps", 50), device=predictor.device)
    metrics = Metrics(eval_trim_beats=hparams.get("eval_trim_beats", 5))
    return predictor, postprocessor, metrics


def compute_predictions(predictor, postprocessor, metrics, datamodule, return_preds=False):
    from beat_this_tpu_torch.inference import predict_postprocess_batched

    print("Computing predictions ...")
    piece_metrics, datasets, pieces, preds = [], [], [], []
    for piece, beat, downbeat in predict_postprocess_batched(
        predictor, postprocessor, datamodule.predict_pieces()
    ):
        m_beat = metrics(piece["truth_orig_beat"], beat, step="test")
        m_down = metrics(piece["truth_orig_downbeat"], downbeat, step="test")
        piece_metrics.append({**{f"{k}_beat": v for k, v in m_beat.items()},
                              **{f"{k}_downbeat": v for k, v in m_down.items()}})
        datasets.append(piece["dataset"])
        pieces.append(piece["spect_path"])
        if return_preds:
            preds.append((beat, downbeat))
    metrics_arrays = {k: np.asarray([m[k] for m in piece_metrics]) for k in piece_metrics[0]}
    return metrics_arrays, np.asarray(datasets), preds, np.asarray(pieces)


def write_predictions(fn, preds, pieces):
    from beat_this_tpu_torch.utils import infer_beat_numbers

    np.savez(fn, **{str(name): np.vstack([beats, infer_beat_numbers(beats, downbeats)]).T
                    for name, (beats, downbeats) in zip(pieces, preds)})


def print_dataset_metrics(metrics, datasets):
    print("Dataset metrics")
    for k, v in metrics.items():
        print(k)
        for d in np.unique(datasets):
            print(f"{d}: {round(float(np.mean(v[datasets == d])), 3)}")
        print("------")


def main(args):
    from beat_this_tpu_torch.inference import resolve_device
    from beat_this_tpu_torch.io.checkpoint import load_checkpoint

    device = resolve_device(args.device)
    data_dir = Path(args.data_dir)
    if len(args.models) == 1:
        print("Single model prediction for", args.models[0])
        checkpoint = load_checkpoint(args.models[0])
        datamodule = datamodule_setup(checkpoint, args.num_workers, args.datasplit, data_dir)
        predictor, postprocessor, metrics = model_setup(
            checkpoint, args.eval_trim_beats, args.dbn, device=device)
        metrics_arrays, datasets, preds, pieces = compute_predictions(
            predictor, postprocessor, metrics, datamodule,
            return_preds=bool(args.dump_predictions))
        print("Metrics")
        for k, v in metrics_arrays.items():
            print(f"{k}: {np.mean(v)}")
        print_dataset_metrics(metrics_arrays, datasets)
        if args.dump_predictions:
            write_predictions(args.dump_predictions, preds, pieces)
    elif args.aggregation_type == "mean-std":
        if args.dump_predictions:
            print("cannot dump predictions when doing inference for multiple models")
            return
        checkpoint = load_checkpoint(args.models[0])
        datamodule = datamodule_setup(checkpoint, args.num_workers, args.datasplit, data_dir)
        all_metrics = []
        for checkpoint_path in args.models:
            checkpoint = load_checkpoint(checkpoint_path)
            predictor, postprocessor, metrics = model_setup(
                checkpoint, args.eval_trim_beats, args.dbn, device=device)
            metrics_arrays, *_ = compute_predictions(predictor, postprocessor, metrics,
                                                     datamodule)
            all_metrics.append({k: np.mean(v) for k, v in metrics_arrays.items()})
        print("Metrics")
        for k in all_metrics[0]:
            vals = [m[k] for m in all_metrics]
            print(f"{k}: {round(float(np.mean(vals)), 3)} +- {round(float(np.std(vals)), 3)}")
    elif args.aggregation_type == "k-fold":
        all_metrics, all_datasets, all_preds, all_pieces = [], [], [], []
        for i, checkpoint_path in enumerate(args.models):
            print(f"Model {i + 1}/{len(args.models)}")
            checkpoint = load_checkpoint(checkpoint_path)
            datamodule = datamodule_setup(checkpoint, args.num_workers, args.datasplit,
                                          data_dir)
            predictor, postprocessor, metrics = model_setup(
                checkpoint, args.eval_trim_beats, args.dbn, device=device)
            metrics_arrays, datasets, preds, pieces = compute_predictions(
                predictor, postprocessor, metrics, datamodule,
                return_preds=bool(args.dump_predictions))
            all_metrics.append(metrics_arrays)
            all_datasets.append(datasets)
            all_preds.extend(preds)
            all_pieces.append(pieces)
        merged = {k: np.concatenate([m[k] for m in all_metrics]) for k in all_metrics[0]}
        all_datasets = np.concatenate(all_datasets)
        all_pieces = np.concatenate(all_pieces)
        if len(all_pieces) != len(np.unique(all_pieces)):  # raised also under python -O
            raise AssertionError("There are repeated pieces in the folds")
        print_dataset_metrics(merged, all_datasets)
        if args.dump_predictions:
            write_predictions(args.dump_predictions, all_preds, all_pieces)
    else:
        raise ValueError(f"Unknown aggregation type {args.aggregation_type}")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m beat_this_tpu_torch.compute_paper_metrics",
        description="Computes predictions for a given model and dataset, "
        "prints metrics, and optionally dumps predictions to a given file.")
    parser.add_argument("--models", type=str, nargs="+", required=True)
    parser.add_argument("--datasplit", type=str, choices=("train", "val", "test"),
                        default="val")
    parser.add_argument("--data-dir", type=str, default=str(REPO / "data"))
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--eval_trim_beats", metavar="SECONDS", type=float, default=None)
    parser.add_argument("--dbn", default=None, action=argparse.BooleanOptionalAction)
    parser.add_argument("--aggregation-type", type=str, choices=("mean-std", "k-fold"),
                        default="mean-std")
    parser.add_argument("--dump-predictions", metavar="FILENAME", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on, e.g. cuda, cuda:1 or cpu")
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
