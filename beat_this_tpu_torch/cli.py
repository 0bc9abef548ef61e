#!/usr/bin/env python3
"""Beat This! command-line inference on PyTorch (CUDA by default).

Same flags as beat_this_tpu/cli.py and the reference's console script
(beat_this/cli.py): detects beats and downbeats in audio files or
directories and writes `.beats` TSV files. `--gpu N` runs on cuda:N and
`--gpu -1` on the CPU; `--float16` selects bfloat16 compute; `--dbn` decodes
with the DBN postprocessor. Several inputs or a directory run in groups of
`--batch-files` files that share one batched forward and one batched
postprocess (`inference.BatchedFile2File`), with the per-file path's output.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

try:
    import tqdm
except ImportError:  # pragma: no cover
    tqdm = None


def get_parser():
    parser = argparse.ArgumentParser(
        description="Beat This! beat tracker (PyTorch): writes a .beats TSV "
        "(time<TAB>beat-number) per input audio file."
    )
    parser.add_argument(
        "inputs", type=str, nargs="+",
        help="audio files and/or directories to scan recursively",
    )
    parser.add_argument(
        "--model", type=str, default="final0",
        help="checkpoint to run: a released shortname (fetched and cached on "
             "first use), a local path, or a URL [%(default)s]",
    )
    parser.add_argument(
        "--output", "-o", type=str, default=None,
        help="where results go: a file name (single input) or a base "
             "directory (mirrors the input tree); by default each result "
             "lands beside its input, named per --suffix/--append",
    )
    parser.add_argument(
        "--suffix", "-s", type=str, default=".beats",
        help="extension for derived output names [%(default)s]",
    )
    parser.add_argument(
        "--append", action="store_true",
        help="keep the input's own extension and add the suffix after it",
    )
    parser.add_argument(
        "--skip-existing", action="store_true",
        help="leave already-present output files untouched",
    )
    parser.add_argument(
        "--touch-first", action="store_true",
        help="claim each output by creating it empty before processing; with "
             "--skip-existing this shards one directory across processes",
    )
    parser.add_argument(
        "--dbn", default=False, action=argparse.BooleanOptionalAction,
        help="decode beats with the DBN postprocessor instead of peak picking",
    )
    parser.add_argument(
        "--gpu", type=int, default=0,
        help="CUDA device index; -1 runs on the CPU [%(default)s]",
    )
    parser.add_argument(
        "--float16", action="store_true", help="compute in bfloat16",
    )
    parser.add_argument(
        "--activations", action="store_true",
        help="also dump the framewise beat/downbeat logits as a .npy file",
    )
    parser.add_argument(
        "--batch-files", type=int, default=8,
        help="files per batched forward and postprocess in directory mode [%(default)s]",
    )
    return parser


def derive_output_path(input_path, suffix, append, output=None, parent=None):
    """Map an input audio path to its output path (reference
    beat_this/cli.py:92-111): beside the input, or re-rooted under `output`
    relative to the command-line directory `parent`; `suffix` replaces the
    extension, or with `append` follows the whole name."""
    target = Path(input_path)
    if output is not None:
        rel = target.relative_to(parent) if parent is not None else target.name
        target = Path(output) / rel
    name = target.name + suffix if append else target.stem + suffix
    return target.with_name(name)


def _gather_jobs(inputs, suffix, append, output, skip_existing):
    """(audio_path, beats_path) jobs; directories are walked recursively and
    files already carrying the suffix are skipped (reference
    beat_this/cli.py:161-173)."""
    jobs = []
    for entry in inputs:
        if not entry.is_dir():
            jobs.append((entry, derive_output_path(entry, suffix, append, output)))
            continue
        for candidate in entry.rglob("*"):
            if candidate.is_dir() or candidate.name.endswith(suffix):
                continue
            beats_path = derive_output_path(candidate, suffix, append, output, parent=entry)
            if skip_existing and beats_path.exists():
                continue
            jobs.append((candidate, beats_path))
    return jobs


def _claim_jobs(jobs, touch_first, skip_existing):
    """The jobs this process owns; with `touch_first` each output is claimed
    by creating it empty (whoever creates it first wins)."""
    if not touch_first:
        if skip_existing:
            return [job for job in jobs if not job[1].exists()]
        return list(jobs)
    owned = []
    for job in jobs:
        try:
            job[1].parent.mkdir(parents=True, exist_ok=True)
            job[1].touch(exist_ok=not skip_existing)
        except FileExistsError:
            continue
        owned.append(job)
    return owned


def run(
    inputs,
    model,
    output,
    suffix,
    append,
    skip_existing,
    touch_first,
    dbn,
    gpu,
    float16,
    activations,
    batch_files=8,
):
    from beat_this_tpu_torch.inference import BatchedFile2File
    from beat_this_tpu_torch.io.audio import load_audio
    from beat_this_tpu_torch.utils import save_beat_tsv

    device = "cpu" if gpu < 0 else f"cuda:{gpu}"
    if not float16:
        # float32 means float32: cuDNN would otherwise run the convolutions
        # in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    file2file = BatchedFile2File(model, device, float16, dbn, group_size=max(1, batch_files))
    audio_seconds = 0.0
    t0 = time.perf_counter()

    def dump_activations(_path, beats_path, beat_logits, downbeat_logits):
        np.save(Path(beats_path).with_suffix(".npy"), np.vstack([beat_logits, downbeat_logits]))

    inputs = [Path(item) for item in inputs]
    if output is not None:
        output = Path(output)
    if len(inputs) == 1 and not inputs[0].is_dir():
        if output is None or output.is_dir():
            output = derive_output_path(inputs[0], suffix, append, output)
        signal, sr = load_audio(inputs[0])
        audio_seconds += len(signal) / sr
        logits = file2file.spect2frames(file2file.signal2spect(signal, sr))
        if activations:
            dump_activations(inputs[0], output, *logits)
        save_beat_tsv(*file2file.frames2beats(*logits), output)
    else:
        jobs = _gather_jobs(inputs, suffix, append, output, skip_existing)
        claimed = _claim_jobs(jobs, touch_first, skip_existing)
        progress = tqdm.tqdm(total=len(claimed)) if tqdm is not None else None

        def on_error(audio_path, exc):  # one bad file must not stop the run
            print(
                f"beat_this_tpu_torch: {audio_path} failed ({type(exc).__name__}: {exc})",
                file=sys.stderr,
            )
            if progress is not None:
                progress.update(1)

        def after_each(audio_path, beats_path, beat_logits, downbeat_logits):
            if activations:
                dump_activations(audio_path, beats_path, beat_logits, downbeat_logits)
            if progress is not None:
                progress.update(1)

        audio_seconds += file2file.process_many(claimed, on_error=on_error,
                                                after_each=after_each)
        if progress is not None:
            progress.close()
    elapsed = time.perf_counter() - t0
    print(
        f"{audio_seconds:.1f} s audio in {elapsed:.1f} s "
        f"({audio_seconds / max(elapsed, 1e-9):.1f}x real-time)",
        file=sys.stderr,
    )


def main():
    run(**vars(get_parser().parse_args()))


if __name__ == "__main__":
    sys.exit(main())
