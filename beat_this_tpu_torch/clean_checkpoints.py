"""Strip checkpoints for distribution: keep only the state dict and the
hyperparameters needed to rebuild the model and the data module, dropping
the optimizer and resume state (the port trainer's `beat_this_tpu_torch`
entry, the JAX trainer's `beat_this_tpu`), counterpart of
launch_scripts/clean_checkpoints.py (reference
launch_scripts/clean_checkpoints.py:17-32). Checkpoints of either package go
in; the cleaned file loads in both. It computes nothing, so it takes no
device.

    python -m beat_this_tpu_torch.clean_checkpoints a.ckpt b.ckpt --suffix
"""

from __future__ import annotations

import argparse
from pathlib import Path

KEEP_KEYS = (
    "state_dict",
    "hyper_parameters",
    "datamodule_hyper_parameters",
    "pytorch-lightning_version",
)


def clean(path, suffix: bool = False) -> Path:
    """Write the cleaned checkpoint of `path`: over it, or with `suffix` to
    `<stem>.cleaned.ckpt` beside it. Returns where it went."""
    import torch

    path = Path(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    cleaned = {k: ckpt[k] for k in KEEP_KEYS if k in ckpt}
    # drop non-portable path entries (reference clean_checkpoints.py:28-30)
    cleaned.get("datamodule_hyper_parameters", {}).pop("data_dir", None)
    out = path.with_suffix(".cleaned.ckpt") if suffix else path
    torch.save(cleaned, out)
    return out


def main(args) -> None:
    for fn in args.checkpoints:
        print(f"wrote {clean(fn, args.suffix)}")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.clean_checkpoints",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("checkpoints", nargs="+", help="checkpoint files to clean")
    parser.add_argument("--suffix", action="store_true",
                        help="write to *.cleaned.ckpt instead of overwriting in place")
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
