"""Offline data preparation pipeline of the PyTorch port, counterpart of
launch_scripts/preprocess_audio.py (and of the reference's), three
idempotent stages:

1. **Audio preprocessing**: for every dataset listed in
   ``data/audio_paths.tsv`` (CSV rows ``dataset_name,audio_dir``), downmix to
   mono, resample to 22050 Hz and write ``mono_tracks/<ds>/<piece>/track.wav``
   plus precomputed pitch (-5..+6 semitones) and tempo (+/-20 %, stride 4)
   variants rendered at 44100 Hz with the phase-vocoder ops and resampled
   back.
2. **Spectrogram creation**: every wav -> the port's log-mel
   (`ops/mel.py`) on the chosen device (`--device`, the card by default) ->
   float16 ``spectrograms/<ds>/<piece>/track*.npy``.
3. **Bundling**: each dataset's spectrogram dir -> one uncompressed
   ``<ds>.npz`` (GTZAN without augmentations).

Every stage skips existing outputs, so interrupted runs resume cleanly.
The resampling, pitch and tempo variants run on the host (`io/audio.py`,
`ops/resample.py`, `ops/stretch.py`: the port's copies of the JAX
package's), so stage 1 writes the same bytes as the JAX script.

    python -m beat_this_tpu_torch.preprocess_audio --stage all
"""

from __future__ import annotations

import argparse
import concurrent.futures
from pathlib import Path

import numpy as np

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    def tqdm(x, **kw):
        return x

BASEPATH = Path(__file__).resolve().parent.parent


def augmentation_dict(pitch_shift, time_stretch):
    augmentations = {}
    if pitch_shift:
        augmentations["pitch"] = {"min": pitch_shift[0], "max": pitch_shift[1]}
    if time_stretch:
        augmentations["tempo"] = {
            "min": -time_stretch[0],
            "max": time_stretch[0],
            "stride": time_stretch[1] if len(time_stretch) > 1 else 1,
        }
    return augmentations


class AudioPreprocessing:
    def __init__(self, orig_audio_paths, out_sr=22050, aug_sr=44100, ext="wav",
                 pitch_shift=(-5, 6), time_stretch=(20, 4), verbose=False):
        self.audio_dir = BASEPATH / "data" / "audio"
        self.annotation_dir = BASEPATH / "data" / "annotations"
        self.audio_dirs = {}
        for line in Path(orig_audio_paths).read_text().splitlines():
            if line.strip():
                name, path = line.split(",", 1)
                self.audio_dirs[name.strip()] = path.strip()
        if not self.annotation_dir.exists():
            raise RuntimeError(
                f"{self.annotation_dir} missing, check instructions in "
                "README.md how to obtain the annotations."
            )
        self.out_sr = out_sr
        self.aug_sr = aug_sr
        self.ext = ext
        self.pitch_shift = pitch_shift
        self.time_stretch = time_stretch
        self.verbose = verbose

    def preprocess_audio(self):
        from beat_this_tpu_torch.data.augment import precomputed_augmentation_filenames

        print("stage 1/3: converting audio to mono wav ...")
        self.augmentations = augmentation_dict(self.pitch_shift, self.time_stretch)
        self.expected = precomputed_augmentation_filenames(
            self.augmentations, self.ext
        )
        tasks = []
        for dataset_name, audio_dir in self.audio_dirs.items():
            for audio_path in sorted(Path(audio_dir).iterdir()):
                if audio_path.stem[:12] in ("gtzan_speech", "gtzan_music_"):
                    continue
                tasks.append((dataset_name, audio_path))
        processed = 0
        with concurrent.futures.ThreadPoolExecutor() as ex:
            futures = [
                ex.submit(self.process_audio_file, ds, p) for ds, p in tasks
            ]
            for future in tqdm(
                concurrent.futures.as_completed(futures), total=len(futures)
            ):
                if future.result():
                    processed += 1
        print(f"stage 1/3 done: {processed} pieces converted")

    def process_audio_file(self, dataset_name, audio_path):
        from beat_this_tpu_torch.io.audio import load_audio, save_wav
        from beat_this_tpu_torch.ops.resample import resample
        from beat_this_tpu_torch.ops.stretch import pitch_shift, time_stretch

        beat_path = (
            self.annotation_dir / dataset_name / "annotations" / "beats"
            / (audio_path.stem + ".beats")
        )
        if not beat_path.exists():
            print(f"no .beats annotation at {beat_path}; skipping {audio_path}")
            return False
        folder = self.audio_dir / "mono_tracks" / dataset_name / audio_path.stem
        if all((folder / fn).exists() for fn in self.expected):
            if self.verbose:
                print(f"{folder}: every output already present, nothing to do")
            return True
        try:
            waveform, sr = load_audio(audio_path)
        except Exception as e:  # noqa: BLE001
            print(f"skipping {audio_path}: could not decode audio ({e})")
            return False
        if waveform.ndim != 1:
            waveform = waveform.mean(axis=1)
        folder.mkdir(parents=True, exist_ok=True)
        mono_path = folder / f"track.{self.ext}"
        if not mono_path.exists():
            out = resample(waveform, sr, self.out_sr) if sr != self.out_sr else waveform
            save_wav(mono_path, out, self.out_sr)
        if not self.augmentations:
            return True
        aug_wave = (
            resample(waveform, sr, self.aug_sr) if sr != self.aug_sr else waveform
        )
        for fn in self.expected:
            path = folder / fn
            if path.exists() or fn == f"track.{self.ext}":
                continue
            stem_parts = Path(fn).stem.split("_")
            if stem_parts[-1].startswith("ps"):
                shifted = pitch_shift(
                    aug_wave, self.aug_sr, int(stem_parts[-1][2:])
                )
            else:  # tsN: percentage of tempo change
                factor = 1.0 + int(stem_parts[-1][2:]) / 100
                shifted = time_stretch(aug_wave, factor)
            save_wav(path, resample(shifted, self.aug_sr, self.out_sr), self.out_sr)
        return True


class SpectCreation:
    def __init__(self, pitch_shift, time_stretch, audio_sr=22050, verbose=False,
                 device="cuda"):
        from beat_this_tpu_torch.data.augment import precomputed_augmentation_filenames
        from beat_this_tpu_torch.inference import resolve_device

        self.audio_dir = BASEPATH / "data" / "audio"
        self.mono_tracks_dir = self.audio_dir / "mono_tracks"
        self.spectrograms_dir = self.audio_dir / "spectrograms"
        self.annotations_dir = BASEPATH / "data" / "annotations"
        self.audio_sr = audio_sr
        self.verbose = verbose
        self.device = resolve_device(device)
        self.filenames = precomputed_augmentation_filenames(
            augmentation_dict(pitch_shift, time_stretch), "wav"
        )

    def create_spects(self):
        print("stage 2/3: computing log-mel spectrograms ...")
        tasks = []
        for dataset_dir in sorted(self.mono_tracks_dir.iterdir()):
            for piece_dir in sorted(dataset_dir.iterdir()):
                tasks.append((piece_dir, dataset_dir.name))
        processed = 0
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            futures = [
                ex.submit(self.create_spect_piece, p, d) for p, d in tasks
            ]
            for future in tqdm(
                concurrent.futures.as_completed(futures), total=len(futures)
            ):
                if future.result():
                    processed += 1
        print(f"stage 2/3 done: {processed} spectrograms under {self.spectrograms_dir}")

    def create_spect_piece(self, piece_dir, dataset_name):
        import torch

        from beat_this_tpu_torch.io.audio import load_audio
        from beat_this_tpu_torch.ops.mel import log_mel_spectrogram

        beat_path = (
            self.annotations_dir / dataset_name / "annotations" / "beats"
            / f"{piece_dir.name}.beats"
        )
        if not beat_path.exists():
            return False
        done = False
        for filename in self.filenames:
            wav = piece_dir / filename
            if not wav.exists():
                continue
            out = (
                self.spectrograms_dir / dataset_name / piece_dir.name
                / (Path(filename).stem + ".npy")
            )
            if out.exists():
                done = True
                continue
            waveform, sr = load_audio(wav, dtype="float32")
            assert sr == self.audio_sr, f"{wav}: expected {self.audio_sr}, got {sr}"
            spect = log_mel_spectrogram(torch.from_numpy(waveform).to(self.device))
            spect = spect.cpu().numpy().astype(np.float16)
            out.parent.mkdir(parents=True, exist_ok=True)
            try:
                np.save(out, spect)
            except KeyboardInterrupt:
                out.unlink()
                raise
            done = True
        return done


def create_npz(spectrograms_dir, datasets=None):
    """Bundle per-piece .npy dirs into one uncompressed .npz per dataset."""
    from zipfile import ZIP_STORED, ZipFile

    spectrograms_dir = Path(spectrograms_dir)
    for dataset_dir in sorted(spectrograms_dir.iterdir()):
        if not dataset_dir.is_dir():
            continue
        if datasets and dataset_dir.name not in datasets:
            continue
        npz_path = dataset_dir.with_suffix(".npz")
        if npz_path.exists():
            print(f"{npz_path} exists, skipping")
            continue
        print(f"bundling {dataset_dir} -> {npz_path}")
        with ZipFile(npz_path, "w", ZIP_STORED) as zf:
            for npy in sorted(dataset_dir.rglob("*.npy")):
                member = npy.relative_to(dataset_dir).as_posix()
                # GTZAN is test-only: skip augmentations
                if dataset_dir.name == "gtzan" and npy.stem != "track":
                    continue
                zf.write(npy, member)


def main(args):
    pitch = tuple(args.pitch_shift) if args.pitch_shift else None
    tempo = tuple(args.time_stretch) if args.time_stretch else None
    if args.stage in ("audio", "all"):
        prep = AudioPreprocessing(
            args.audio_paths, pitch_shift=pitch, time_stretch=tempo,
            verbose=args.verbose,
        )
        prep.preprocess_audio()
    if args.stage in ("spect", "all"):
        SpectCreation(pitch, tempo, verbose=args.verbose, device=args.device).create_spects()
    if args.stage in ("npz", "all"):
        create_npz(BASEPATH / "data" / "audio" / "spectrograms")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.preprocess_audio",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--audio-paths", type=str,
        default=str(BASEPATH / "data" / "audio_paths.tsv"),
        help="CSV of dataset_name,audio_dir rows",
    )
    parser.add_argument("--stage", choices=("audio", "spect", "npz", "all"),
                        default="all")
    parser.add_argument("--pitch-shift", type=int, nargs=2, default=(-5, 6))
    parser.add_argument("--time-stretch", type=int, nargs=2, default=(20, 4))
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the spectrogram stage, e.g. cuda or cpu")
    return parser


if __name__ == "__main__":
    main(get_parser().parse_args())
