"""Training driver of the PyTorch port, argument-compatible with
launch_scripts/train.py (and so with the reference's), plus `--device`:

    python -m beat_this_tpu_torch.train --data-dir data --no-partial-transformers

On CUDA every configuration trains through the hand-written training
kernels; on the CPU through their plain versions. Set the JAX driver's
variables (BEAT_THIS_COORDINATOR, BEAT_THIS_NUM_PROCESSES,
BEAT_THIS_PROCESS_ID) in each of N processes, or run it under torchrun with
BEAT_THIS_DISTRIBUTED=1, and it trains data-parallel, one process per
device (`parallel/distributed.py`); `--batch-size` is then the global batch.
"""

from __future__ import annotations

import argparse
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent


def main(args) -> object:
    """Train, then test; returns the final TrainState."""
    import numpy as np

    from beat_this_tpu_torch.data import BeatDataModule
    from beat_this_tpu_torch.model.beat_this import BeatThisConfig
    from beat_this_tpu_torch.parallel.distributed import (
        host_shard,
        maybe_initialize_distributed,
        rank_device,
    )
    from beat_this_tpu_torch.train.task import TrainConfig
    from beat_this_tpu_torch.train.trainer import Trainer

    np.random.seed(args.seed)
    device = args.device
    if maybe_initialize_distributed():
        rank, world = host_shard()
        print(f"Multi-host run: process {rank} of {world}, {world} global devices")
        if device == "cuda":
            device = rank_device()
    print("Starting a new run with the following parameters:")
    print(args)

    augmentations = {}
    if args.tempo_augmentation:
        augmentations["tempo"] = {"min": -20, "max": 20, "stride": 4}
    if args.pitch_augmentation:
        augmentations["pitch"] = {"min": -5, "max": 6}
    if args.mask_augmentation:
        augmentations["mask"] = {
            "kind": "permute", "min_count": 1, "max_count": 6, "min_len": 0.1,
            "max_len": 2, "min_parts": 5, "max_parts": 9,
        }
    datamodule = BeatDataModule(
        Path(args.data_dir),
        batch_size=args.batch_size,
        train_length=args.train_length,
        spect_fps=args.fps,
        num_workers=args.num_workers,
        test_dataset="gtzan",
        length_based_oversampling_factor=args.length_based_oversampling_factor,
        augmentations=augmentations,
        hung_data=args.hung_data,
        no_val=not args.val,
        fold=args.fold,
        seed=args.seed,
    )
    datamodule.setup(stage="fit")
    pos_weights = datamodule.get_train_positive_weights(widen_target_mask=3)
    print("Using positive weights: ", pos_weights)

    model_config = BeatThisConfig(
        spect_dim=128, transformer_dim=args.transformer_dim, ff_mult=4,
        n_layers=args.n_layers, stem_dim=32, head_dim=32,
        dropout_frontend=args.frontend_dropout,
        dropout_transformer=args.transformer_dropout,
        sum_head=args.sum_head, partial_transformers=args.partial_transformers,
    )
    train_config = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay, warmup_steps=args.warmup_steps,
        accum_steps=args.accumulate_grad_batches, loss_type=args.loss,
        pos_weight_beat=pos_weights["beat"], pos_weight_downbeat=pos_weights["downbeat"],
        compute_dtype=args.precision,
    )
    params_str = (
        f"{'noval ' if not args.val else ''}{'hung ' if args.hung_data else ''}"
        f"{'fold' + str(args.fold) + ' ' if args.fold is not None else ''}"
        f"{args.loss}-h{args.transformer_dim}"
    )
    trainer = Trainer(
        model_config, train_config, datamodule,
        max_epochs=args.max_epochs, val_frequency=args.val_frequency,
        checkpoint_dir=Path(args.checkpoint_dir),
        name=f"{args.name} {params_str}".strip(), seed=args.seed, use_dbn=args.dbn,
        eval_trim_beats=args.eval_trim_beats, fps=args.fps, log_file=args.log_file,
        device=device,
    )
    if args.logger == "wandb":
        trainer.init_wandb(name=f"{args.name} {params_str}".strip(), resume_id=args.resume_id)
    state = trainer.fit(resume_path=args.resume_checkpoint, max_steps_override=args.max_steps)
    trainer.test(state)
    return state


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.train")
    parser.add_argument("--name", type=str, default="")
    parser.add_argument("--data-dir", type=str, default=str(REPO / "data"))
    parser.add_argument("--checkpoint-dir", type=str, default=str(REPO / "checkpoints"))
    parser.add_argument("--n-layers", type=int, default=6)
    parser.add_argument("--transformer-dim", type=int, default=512)
    parser.add_argument("--frontend-dropout", type=float, default=0.1)
    parser.add_argument("--transformer-dropout", type=float, default=0.2)
    parser.add_argument("--lr", type=float, default=0.0008)
    parser.add_argument("--weight-decay", type=float, default=0.01)
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--fps", type=int, default=50)
    parser.add_argument(
        "--loss", type=str, default="shift_tolerant_weighted_bce",
        choices=["shift_tolerant_weighted_bce", "splitted_shift_tolerant_weighted_bce",
                 "weighted_bce", "bce"],
    )
    parser.add_argument("--warmup-steps", type=int, default=1000)
    parser.add_argument("--max-epochs", type=int, default=100)
    parser.add_argument("--max-steps", type=int, default=None,
                        help="Stop after this many optimizer steps (smoke runs).")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--accumulate-grad-batches", type=int, default=8)
    parser.add_argument("--train-length", type=int, default=1500)
    parser.add_argument("--dbn", default=False, action=argparse.BooleanOptionalAction)
    parser.add_argument("--eval-trim-beats", metavar="SECONDS", type=float, default=5)
    parser.add_argument("--val-frequency", metavar="N", type=int, default=5)
    parser.add_argument("--precision", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="Compute dtype (bfloat16 = mixed precision, the counterpart "
                             "of the reference's 16-mixed).")
    parser.add_argument("--tempo-augmentation", default=True,
                        action=argparse.BooleanOptionalAction)
    parser.add_argument("--pitch-augmentation", default=True,
                        action=argparse.BooleanOptionalAction)
    parser.add_argument("--mask-augmentation", default=True,
                        action=argparse.BooleanOptionalAction)
    parser.add_argument("--sum-head", default=True, action=argparse.BooleanOptionalAction)
    parser.add_argument("--partial-transformers", default=True,
                        action=argparse.BooleanOptionalAction)
    parser.add_argument("--length-based-oversampling-factor", type=float, default=0.65)
    parser.add_argument("--val", default=True, action=argparse.BooleanOptionalAction)
    parser.add_argument("--hung-data", default=False, action=argparse.BooleanOptionalAction)
    parser.add_argument("--fold", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resume-checkpoint", type=str, default=None)
    parser.add_argument("--resume-id", type=str, default=None,
                        help="wandb run id to continue when resuming")
    parser.add_argument("--logger", type=str, choices=["wandb", "none"], default="none")
    parser.add_argument("--log-file", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on, e.g. cuda, cuda:1 or cpu")
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
