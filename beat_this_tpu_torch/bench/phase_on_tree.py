"""One phase of this checkout's `chip_smoke.py` against the package of
another checkout, to compare two versions of the kernels in one run on one
card (for example a parent commit unpacked with `git archive`):

    python3 beat_this_tpu_torch/bench/phase_on_tree.py kernels DIR [NAME ...]
    python3 beat_this_tpu_torch/bench/phase_on_tree.py train-kernels DIR [NAME ...]
    python3 beat_this_tpu_torch/bench/phase_on_tree.py attn-kernels DIR [NAME ...]
    python3 beat_this_tpu_torch/bench/phase_on_tree.py ablation-kernels DIR [NAME ...]

Run it as a script, not with `-m`: DIR goes first on `sys.path`, so the
phase imports (and builds the kernels of) DIR's `beat_this_tpu_torch`, while
the cases, timings and bounds are this checkout's. `kernels` is phase 3's
eval kernels (K1, K2, K3), `train-kernels` phase 3b (the six training
kernels), `attn-kernels` phase 3c (B10-B12 at the head_dim 16 shapes),
`ablation-kernels` phase 3d (B13-B15 in both dtypes, without the bench
entry points); NAMEs (the kernel names of `chip_smoke.py`'s KERNELS, for
example fused_freq_roformer, fused_freq_roformer_train_fwd or
flash_attention_bwd) keep only their cases.
Prints the phase's lines; needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"
PHASES = {"kernels": "phase_kernels", "train-kernels": "phase_train_kernels",
          "attn-kernels": "phase_attention_kernels",
          "ablation-kernels": "phase_ablation_kernels"}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2 or argv[0] not in PHASES:
        raise SystemExit(f"usage: phase_on_tree.py {{{'|'.join(PHASES)}}} DIR [NAME ...]")
    phase, tree, only = argv[0], str(Path(argv[1]).resolve()), tuple(argv[2:])
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    import beat_this_tpu_torch

    if not str(Path(beat_this_tpu_torch.__file__).resolve()).startswith(tree):
        raise SystemExit(f"imported {beat_this_tpu_torch.__file__}, not the package of {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("phase_on_tree: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[phase_on_tree] {phase} of {SMOKE} on the package of {tree}")
    unknown = set(only) - set(smoke.KERNELS)
    if unknown:
        raise SystemExit(f"phase_on_tree: no kernels named {sorted(unknown)}")
    if phase == "ablation-kernels" and not only:
        only = smoke.ABLATION_KERNELS  # the cases, not the entry points
    getattr(smoke, PHASES[phase])(smoke.nvidia_smi_line(), only)


if __name__ == "__main__":
    main()
