"""One phase of this checkout's `chip_smoke.py` against the package of
another checkout, to compare two versions of the kernels in one run on one
card (for example a parent commit unpacked with `git archive`):

    python3 beat_this_tpu_torch/bench/phase_on_tree.py kernels DIR [NAME ...]
    python3 beat_this_tpu_torch/bench/phase_on_tree.py train-kernels DIR [NAME ...]
    python3 beat_this_tpu_torch/bench/phase_on_tree.py attn-kernels DIR [NAME ...]
    python3 beat_this_tpu_torch/bench/phase_on_tree.py ablation-kernels DIR [NAME ...]
    python3 beat_this_tpu_torch/bench/phase_on_tree.py cli-dir DIR

Run it as a script, not with `-m`: DIR goes first on `sys.path`, so the
phase imports (and builds the kernels of) DIR's `beat_this_tpu_torch`, while
the cases, timings and bounds are this checkout's. `kernels` is phase 3's
eval kernels (K1, K2, K3), `train-kernels` phase 3b (the six training
kernels), `attn-kernels` phase 3c (B10-B12 at the head_dim 16 shapes),
`ablation-kernels` phase 3d (B13-B15 in both dtypes, without the bench
entry points); NAMEs (the kernel names of `chip_smoke.py`'s KERNELS, for
example fused_freq_roformer, fused_freq_roformer_train_fwd or
flash_attention_bwd) keep only their cases.

`cli-dir` is the CLI leg of `bench/cli_dir.py` at its defaults (32 wavs, 11
minutes of audio, the seed-0 full-width checkpoint, `cli.run` with
`--batch-files 32` twice in one process: cold, then warm), in turns on DIR's
package, this checkout's, this checkout's and DIR's, each turn a child
process; the kernels are built once beforehand, under `$BEAT_THIS_TORCH_BUILD`
or a temporary directory (the sources must agree).
It prints each turn's times and whether the warm run's `.beats` files equal
the first turn's.
Prints the phase's lines; needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"
PHASES = {"kernels": "phase_kernels", "train-kernels": "phase_train_kernels",
          "attn-kernels": "phase_attention_kernels",
          "ablation-kernels": "phase_ablation_kernels"}


# one turn of `cli-dir`: argv is the package's root, the wav directory, the
# checkpoint, the output directory and the file count
CLI_TURN = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from beat_this_tpu_torch import cli

def once(out):
    t0 = time.perf_counter()
    cli.run([sys.argv[2]], sys.argv[3], out, ".beats", False, False, False, False, 0, False,
            False, batch_files=int(sys.argv[5]))
    torch.cuda.synchronize()
    return time.perf_counter() - t0

cold = once(sys.argv[4] + "/cold")
print(json.dumps({"package": cli.__file__, "cold_s": cold, "warm_s": once(sys.argv[4] + "/warm")}))
"""


def cli_dir_turns(tree: str) -> None:
    here = str(SMOKE.parent)
    sys.path.insert(0, here)
    import torch

    from beat_this_tpu_torch.bench import cli_dir
    from beat_this_tpu_torch.bench.timing import nvidia_smi_line
    from beat_this_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("phase_on_tree: needs a CUDA device")
    smi = nvidia_smi_line()
    with tempfile.TemporaryDirectory(prefix="cli_dir_turns_") as tmp:
        tmp = Path(tmp)
        os.environ.setdefault("BEAT_THIS_TORCH_BUILD", str(tmp / "build"))
        _build.build()
        args = cli_dir.get_parser().parse_args([])
        files = args.files
        wavs, ckpt, audio_s = cli_dir.write_inputs(tmp, files, args.dim, args.layers)
        print(f"[cli-dir] {files} wavs, {audio_s:.1f} s of audio; turns: {tree} (parent), "
              f"{here}, {here}, {tree} [{smi}]", flush=True)
        first = None
        for turn, root in enumerate((tree, here, here, tree)):
            out = tmp / f"out{turn}"
            done = subprocess.run([sys.executable, "-c", CLI_TURN, root, str(wavs), str(ckpt),
                                   str(out), str(files)], cwd=root, capture_output=True,
                                  text=True)
            if done.returncode:
                raise SystemExit(f"cli-dir turn {turn} on {root} failed:\n{done.stderr[-4000:]}")
            record = json.loads(done.stdout.strip().splitlines()[-1])
            beats = {p.name: p.read_bytes() for p in sorted((out / "warm").glob("*.beats"))}
            first = first or beats
            print(f"[cli-dir] turn {turn}, {record['package']}: cold {record['cold_s']:.4f} s, "
                  f"warm {record['warm_s']:.4f} s ({audio_s / record['warm_s']:.2f}x realtime); "
                  f"{len(beats)} outputs, equal to turn 0's: {beats == first} [{smi}]",
                  flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "cli-dir":
        return cli_dir_turns(str(Path(argv[1]).resolve()))
    if len(argv) < 2 or argv[0] not in PHASES:
        raise SystemExit(f"usage: phase_on_tree.py {{{'|'.join(PHASES)}|cli-dir}} DIR "
                         "[NAME ...]")
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
