"""Where directory mode's group log-mel spends its time: host, upload,
compute and download, for 32 files of mixed length (11 minutes of audio).

    python -m beat_this_tpu_torch.bench.mel_stage [--device cuda] [--out FILE]

Counterpart of tools/profile_mel_stage.py, on the same corpus
(`synth_corpus`). Two recipes, each split into stages:

  stacked  every file padded to the group's longest and stacked: host pad
           and stack, upload of the (files, samples) float32 batch, the
           log-mel on the card, download of the whole padded log-mel
  flat     the packed-flat signal of `inference.pack_flat` (each file in a
           4-hop slot, reflect heads in the previous slot's tail), which
           `BatchedFile2File._batched_spects_device` sends: host packing,
           upload, compute, download

then the production `_batched_spects_device` end to end (host packing,
upload and compute; the log-mel stays on the card), with the corpus as
float audio (float32 upload) and as the int16 samples `_load_one` gives for
16-bit wavs (int16 upload).
`compute` is timed by CUDA events around the log-mel call (device time);
every other stage by the host clock around the stage and a synchronize.
Prints its lines, then one JSON line. `main(argv, sizes)` takes smaller
`Sizes` for tests; the command line runs the defaults.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from beat_this_tpu_torch.bench.timing import bench_device, device_line, median_ms, wall_ms


@dataclasses.dataclass(frozen=True)
class Sizes:
    files: int = 32
    total_sec: float = 660.0  # audio seconds of the corpus before clipping
    reps: int = 5  # timed calls per stage


def synth_corpus(n_files: int = 32, total_sec: float = 660.0, seed: int = 0):
    """tools/profile_mel_stage.py:synth_corpus: a length mix like a music
    directory (lognormal lengths, clipped to 8-65 s), each file a sine plus
    noise, float32 at 22050 Hz."""
    rng = np.random.RandomState(seed)
    raw = rng.lognormal(mean=0.0, sigma=0.5, size=n_files)
    secs = raw / raw.sum() * total_sec
    secs = np.clip(secs, 8.0, 65.0)
    sigs = []
    for i, s in enumerate(secs):
        n = int(s * 22050)
        t = np.arange(n) / 22050.0
        x = 0.2 * np.sin(2 * np.pi * (100 + 7 * i) * t)
        x += 0.05 * rng.randn(n)
        sigs.append(x.astype(np.float32))
    return sigs


def _stages(host, device, reps: int):
    """Stage times (ms) and bytes (MB) of one recipe whose `host()` builds
    the float32 input, and its log-mel on the device."""
    from beat_this_tpu_torch.ops.mel import LogMelConfig, log_mel_spectrogram

    batch = host()
    up = torch.from_numpy(batch).to(device)
    mel = log_mel_spectrogram(up, LogMelConfig())
    return {
        "host_ms": wall_ms(host, device, reps),
        "upload_ms": wall_ms(lambda: torch.from_numpy(batch).to(device), device, reps),
        "upload_mb": batch.nbytes / 1e6,
        "compute_ms": median_ms(lambda: log_mel_spectrogram(up, LogMelConfig()), device, reps,
                                1),
        "download_ms": wall_ms(lambda: mel.cpu(), device, reps),
        "download_mb": mel.numel() * mel.element_size() / 1e6,
        "e2e_ms": wall_ms(lambda: log_mel_spectrogram(torch.from_numpy(host()).to(device),
                                                      LogMelConfig()).cpu(), device, reps),
    }, mel


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.bench.mel_stage",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--out", default=None, help="also write the JSON record here")
    return parser


def main(argv=None, sizes: Sizes = Sizes()) -> dict:
    from beat_this_tpu_torch.inference import BatchedFile2File, _pad_wave_for_mel, pack_flat
    from beat_this_tpu_torch.ops.mel import num_frames

    args = get_parser().parse_args(argv)
    device = bench_device(args.device)
    print(device_line(device))
    sigs = synth_corpus(sizes.files, sizes.total_sec)
    audio_s = sum(len(s) for s in sigs) / 22050.0
    print(f"corpus: {len(sigs)} files, {audio_s:.1f} s audio, longest "
          f"{max(len(s) for s in sigs) / 22050.0:.1f} s")

    width = max(len(s) for s in sigs) + 512

    def stacked_host():
        out = np.zeros((len(sigs), width), np.float32)
        for row, s in zip(out, sigs):
            pad = _pad_wave_for_mel(s)
            row[: len(pad)] = pad
        return out

    f2f = BatchedFile2File.__new__(BatchedFile2File)  # the log-mel needs no model
    f2f.device = device

    record = {"files": len(sigs), "audio_seconds": round(audio_s, 3)}
    stacked, mel_stacked = _stages(stacked_host, device, sizes.reps)
    flat, mel_flat = _stages(lambda: pack_flat(sigs)[0], device, sizes.reps)
    mel_dev, offsets, nframes = f2f._batched_spects_device(sigs)
    mel_stacked, mel_flat = mel_stacked.cpu().numpy(), mel_flat.cpu().numpy()
    worst = max(float(np.abs(mel_stacked[i, :n] - mel_flat[o : o + n]).max())
                for i, (o, n) in enumerate(zip(offsets, nframes)))
    same = bool(np.array_equal(mel_dev.cpu().numpy(), mel_flat))
    assert all(n == num_frames(len(s)) for n, s in zip(nframes, sigs))
    clock = "events" if device.type == "cuda" else "host clock"
    for name, st in (("stacked", stacked), ("flat", flat)):
        print(f"{name:8s}: host {st['host_ms']:8.2f} ms | upload {st['upload_ms']:8.2f} ms "
              f"({st['upload_mb']:.1f} MB) | compute {st['compute_ms']:8.2f} ms ({clock}) | "
              f"download {st['download_ms']:8.2f} ms ({st['download_mb']:.1f} MB) | end to "
              f"end {st['e2e_ms']:8.2f} ms")
        record.update({f"{name}_{k}": round(v, 4) for k, v in st.items()})

    pcm = [np.round(s * 32768.0).clip(-32768, 32767).astype(np.int16) for s in sigs]
    for name, group in (("f32", sigs), ("int16", pcm)):
        sent = pack_flat(group)[0].dtype
        assert sent == (np.int16 if name == "int16" else np.float32), sent
        ms = wall_ms(lambda: f2f._batched_spects_device(group), device, sizes.reps)
        record[f"production_{name}_ms"] = round(ms, 4)
        print(f"production _batched_spects_device, {name} upload: {ms:8.2f} ms (host clock, "
              f"log-mel left on the device)")
    print(f"max |stacked - flat| over every file's frames: {worst:.3e}; production log-mel "
          f"equal to the flat recipe's: {same}")
    record["max_abs_stacked_vs_flat"] = worst
    record["production_equals_flat"] = same
    record["clock"] = f"compute_ms: {clock}; the rest: host clock (and a synchronize on the card)"
    print(json.dumps(record), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=2) + "\n")
    return record


if __name__ == "__main__":
    main()
