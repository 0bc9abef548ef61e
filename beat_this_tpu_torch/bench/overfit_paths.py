"""The full-width overfit run of `overfit_smoke.overfit` on the kernel path or,
with `--plain`, on the kernels' plain versions (every forward of the model,
the training steps' and the scoring's, with `kernels=False`), at the same
settings and seeds. A kernel-path run that
does not learn is held to the plain path's: if the plain path learns and the
kernels do not, a kernel is at fault.

    python -m beat_this_tpu_torch.bench.overfit_paths --epochs 45 --lr 1e-3 [--plain]
        [--compute-dtype bfloat16] [--head-dim 16]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path


@contextlib.contextmanager
def plain_path():
    """Inside, every forward of a BeatThis model (the training steps' and
    the scoring's) takes the kernels' plain versions."""
    from beat_this_tpu_torch.model.beat_this import BeatThis

    forward = BeatThis.forward

    def plain_forward(self, x, *args, **kwargs):
        return forward(self, x, *args, **{**kwargs, "kernels": False})

    BeatThis.forward = plain_forward
    try:
        yield
    finally:
        BeatThis.forward = forward


def main(argv=None) -> int:
    from beat_this_tpu_torch.model.beat_this import BeatThisConfig
    from beat_this_tpu_torch.overfit_smoke import overfit

    parser = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.bench.overfit_paths",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=45)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--head-dim", type=int, default=32)
    parser.add_argument("--plain", action="store_true", help="the kernels' plain versions")
    parser.add_argument("--out", default="OVERFIT_PATH.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    config = BeatThisConfig(head_dim=args.head_dim)
    path = "plain" if args.plain else "kernel"
    with plain_path() if args.plain else contextlib.nullcontext():
        report = overfit(config, epochs=args.epochs, lr=args.lr, compute_dtype=args.compute_dtype,
                         out=Path(args.out), device=args.device)
    print(f"[overfit_paths] {path} path, head_dim {args.head_dim}, {args.compute_dtype}, "
          f"{args.epochs} epochs, lr {args.lr:g}: loss {report['loss_first']:.4f} -> "
          f"{report['loss_last']:.4f}, F beat {report['f_measure_beat']} downbeat "
          f"{report['f_measure_downbeat']}, ok {report['ok']}, fit {report['fit_s']} s")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
