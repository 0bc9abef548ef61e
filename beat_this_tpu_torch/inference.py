"""Inference: checkpoint loading, chunked prediction and the
Spect2Frames / Audio2Frames / Audio2Beats / File2Beats / File2File class
tower, counterpart of beat_this_tpu/inference.py.

A piece longer than one chunk is split on the reference's start grid
(beat_this/inference.py:100-135): overlapping chunks every
chunk_size - 2 * border_size frames, the first and last zero-padded, the
last start shifted left to end at the piece end. Chunks run in batches of
CHUNK_BATCH, and their border-trimmed logits are stitched back with "keep_first"
(earlier chunks win) or "keep_last". A piece of at most one stride runs as a
single shorter chunk of T + 2 * border_size frames, padded to the JAX
package's time buckets and masked through the model's `valid_lengths`.

`ChunkedPredictor.predict_many` packs the chunks of several pieces into
shared forwards, and `BatchedFile2File` runs a directory through it in
groups (mel per file, one batched forward and one batched postprocess per
group); both give what the per-piece path gives.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from beat_this_tpu_torch.io.audio import load_audio
from beat_this_tpu_torch.utils import save_beat_tsv
from beat_this_tpu_torch.io.checkpoint import init_beat_this, load_checkpoint, model_state_dict
from beat_this_tpu_torch.model.beat_this import BeatThis, BeatThisConfig
from beat_this_tpu_torch.ops.mel import LogMelConfig, log_mel_spectrogram, num_frames
from beat_this_tpu_torch.postprocessing.postprocessor import Postprocessor

CHUNK_SIZE = 1500
BORDER_SIZE = 6  # = 2 * loss tolerance (reference pl_module.py:258-263)
# chunks per forward: bounds device memory for long pieces (the frontend
# activations of one 1500-frame chunk are ~6 MB per f32 tensor)
CHUNK_BATCH = 16


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def load_model(checkpoint_path="final0", device="cuda") -> BeatThis:
    """A BeatThis module in eval mode on `device`, from a checkpoint given by
    local path, URL or released shortname (`io.checkpoint.load_checkpoint`;
    reference beat_this/inference.py:56-87). With `None`, a freshly
    initialized default model (`init_beat_this(0, BeatThisConfig())`)."""
    if checkpoint_path is None:
        return _eval_model(BeatThisConfig(), init_beat_this(0, BeatThisConfig()), device)
    return model_from_checkpoint(load_checkpoint(checkpoint_path), device)


def model_from_checkpoint(checkpoint: dict, device="cuda") -> BeatThis:
    """A BeatThis module in eval mode on `device` from a loaded checkpoint
    dict (its `hyper_parameters` and `state_dict`)."""
    config = BeatThisConfig.from_hparams(checkpoint.get("hyper_parameters", {}))
    return _eval_model(config, model_state_dict(checkpoint), device)


def _eval_model(config: BeatThisConfig, state_dict: dict, device) -> BeatThis:
    with torch.device(resolve_device(device)):
        model = BeatThis(config)
    model.load_state_dict(state_dict)
    return model.eval().requires_grad_(False)


def plan_chunks(
    length: int,
    chunk_size: int = CHUNK_SIZE,
    border_size: int = BORDER_SIZE,
    avoid_short_end: bool = True,
) -> np.ndarray:
    """Chunk start indices (the first is negative: the leading pad)."""
    stride = chunk_size - 2 * border_size
    starts = np.arange(-border_size, length - border_size, stride)
    if avoid_short_end and length > stride:
        starts[-1] = length - (chunk_size - border_size)
    return starts


def _time_buckets(chunk_size: int) -> tuple[int, ...]:
    """Padded sequence lengths for pieces shorter than one chunk."""
    return tuple(b for b in (192, 384, 768) if b < chunk_size) + (chunk_size,)


class ChunkedPredictor:
    """Chunked inference of one model on the model's device."""

    def __init__(
        self,
        model: BeatThis,
        chunk_size: int = CHUNK_SIZE,
        border_size: int = BORDER_SIZE,
        compute_dtype: torch.dtype = torch.float32,
        overlap_mode: str = "keep_first",
    ):
        if overlap_mode not in ("keep_first", "keep_last"):
            raise ValueError(f"unknown overlap_mode: {overlap_mode!r}")
        self.model = model
        self.chunk_size = chunk_size
        self.border_size = border_size
        self.compute_dtype = compute_dtype
        self.overlap_mode = overlap_mode

    @property
    def stride(self) -> int:
        return self.chunk_size - 2 * self.border_size

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.inference_mode()
    def _forward(self, batch: np.ndarray, valid_lengths=None):
        x = torch.from_numpy(batch).to(self.device)
        if valid_lengths is not None:
            valid_lengths = torch.from_numpy(valid_lengths).to(self.device)
        out = self.model(x, valid_lengths=valid_lengths, compute_dtype=self.compute_dtype)
        return out["beat"].cpu().numpy(), out["downbeat"].cpu().numpy()

    def _predict_short(self, spects) -> list[tuple[np.ndarray, np.ndarray]]:
        """Each piece as one chunk of T + 2 * border frames, padded to a time
        bucket; the pieces of one bucket share forwards of at most
        CHUNK_BATCH rows."""
        bs = self.border_size
        by_bucket: dict[int, list[int]] = {}
        for idx, spect in enumerate(spects):
            valid = len(spect) + 2 * bs
            padded_t = next(p for p in _time_buckets(self.chunk_size) if p >= valid)
            by_bucket.setdefault(padded_t, []).append(idx)
        results: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for padded_t, indices in by_bucket.items():
            for i in range(0, len(indices), CHUNK_BATCH):
                rows = indices[i : i + CHUNK_BATCH]
                batch = np.zeros((len(rows), padded_t, spects[0].shape[1]), np.float32)
                for row, idx in enumerate(rows):
                    batch[row, bs : bs + len(spects[idx])] = spects[idx]
                valid = np.array([len(spects[idx]) + 2 * bs for idx in rows], np.int64)
                beat, down = self._forward(batch, valid)
                for row, idx in enumerate(rows):
                    t = len(spects[idx])
                    results[idx] = (beat[row, bs : bs + t], down[row, bs : bs + t])
        return [results[i] for i in range(len(spects))]

    def _chunks(self, spect: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """A long piece's chunk starts (in coordinates padded by the border)
        and its zero-padded chunks (n, chunk_size, bins)."""
        cs, bs, stride = self.chunk_size, self.border_size, self.stride
        starts = plan_chunks(len(spect), cs, bs) + bs
        padded = np.zeros((len(starts) * stride + 2 * bs, spect.shape[1]), np.float32)
        padded[bs : bs + len(spect)] = spect
        return starts, np.stack([padded[s : s + cs] for s in starts])

    def _stitch(self, t: int, starts: np.ndarray, beat: np.ndarray, down: np.ndarray):
        """A piece's (T,) logit tracks from its chunks' logits (n, chunk_size)."""
        cs, bs, stride = self.chunk_size, self.border_size, self.stride
        buf_b = np.full(len(starts) * stride, -1000.0, np.float32)
        buf_d = np.full(len(starts) * stride, -1000.0, np.float32)
        order = range(len(starts))
        if self.overlap_mode == "keep_first":
            order = reversed(order)  # later writes win, so write the winners last
        for i in order:
            buf_b[starts[i] : starts[i] + stride] = beat[i, bs : cs - bs]
            buf_d[starts[i] : starts[i] + stride] = down[i, bs : cs - bs]
        return buf_b[:t], buf_d[:t]

    def _predict_long(self, spects) -> list[tuple[np.ndarray, np.ndarray]]:
        """The chunks of all pieces, packed into forwards of at most
        CHUNK_BATCH chunks, then stitched per piece."""
        plans = [self._chunks(spect) for spect in spects]
        chunks = np.concatenate([c for _, c in plans])
        outs = [
            self._forward(chunks[i : i + CHUNK_BATCH])
            for i in range(0, len(chunks), CHUNK_BATCH)
        ]
        beat = np.concatenate([o[0] for o in outs])
        down = np.concatenate([o[1] for o in outs])
        results, offset = [], 0
        for spect, (starts, _) in zip(spects, plans):
            n = len(starts)
            results.append(self._stitch(len(spect), starts, beat[offset : offset + n],
                                        down[offset : offset + n]))
            offset += n
        return results

    def predict_many(self, spects) -> list[tuple[np.ndarray, np.ndarray]]:
        """Several pieces at once: the chunks of all long pieces share their
        forwards, the short pieces go through the time buckets together.
        Every row of a forward is computed on its own, so each piece gets
        the logits `predict` gives it."""
        spects = [np.asarray(s, dtype=np.float32) for s in spects]
        short = [i for i, s in enumerate(spects) if len(s) <= self.stride]
        long = [i for i, s in enumerate(spects) if len(s) > self.stride]
        out: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        if short:
            out.update(zip(short, self._predict_short([spects[i] for i in short])))
        if long:
            out.update(zip(long, self._predict_long([spects[i] for i in long])))
        return [out[i] for i in range(len(spects))]

    def predict(self, spect: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """spect: (T, mel_bins) -> (beat_logits, downbeat_logits), each (T,)
        float32 numpy."""
        return self.predict_many([spect])[0]


def zeropad(spect, left: int = 0, right: int = 0) -> np.ndarray:
    """Zero frames added before and after a (T, F) spectrogram (reference
    beat_this/inference.py:100-107), host-side numpy."""
    spect = np.asarray(spect)
    if not left and not right:
        return spect
    return np.pad(spect, ((left, right), (0, 0)))


def split_piece(spect, chunk_size: int, border_size: int = BORDER_SIZE,
                avoid_short_end: bool = True):
    """(chunks, starts) of a (T, F) spectrogram on `plan_chunks`' grid
    (reference beat_this/inference.py:110-144): chunks overlap by
    2 * border_size, the first and last are zero-padded at the piece's
    edges. `ChunkedPredictor` cuts its chunks itself; this is the
    reference's public helper."""
    spect = np.asarray(spect)
    t = len(spect)
    starts = plan_chunks(t, chunk_size, border_size, avoid_short_end)
    chunks = []
    for start in starts:
        start = int(start)
        lo, hi = max(start, 0), min(start + chunk_size, t)
        chunks.append(zeropad(spect[lo:hi], left=lo - start,
                              right=max(0, min(border_size, start + chunk_size - t))))
    return chunks, starts


def aggregate_prediction(pred_chunks, starts, full_size: int, chunk_size: int,
                         border_size: int, overlap_mode: str, device=None):
    """(beat, downbeat) logits of a whole piece, (full_size,) float32 numpy
    each, from per-chunk dicts of "beat" and "downbeat" logits (reference
    beat_this/inference.py:147-185): borders are cut, uncovered frames stay
    at -1000, and where trimmed chunks overlap "keep_first" lets the earlier
    chunk win and "keep_last" the later. `device` is accepted and unused."""
    if overlap_mode not in ("keep_first", "keep_last"):
        raise ValueError(f"unknown overlap_mode: {overlap_mode!r}")
    del device, chunk_size
    beat = np.full(full_size, -1000.0, np.float32)
    downbeat = np.full(full_size, -1000.0, np.float32)
    items = list(zip(starts, pred_chunks))
    if overlap_mode == "keep_first":
        items = items[::-1]  # later writes win, so write the winners last
    for start, chunk in items:
        start = int(start)
        for out, key in ((beat, "beat"), (downbeat, "downbeat")):
            seg = chunk[key]
            seg = seg.float().cpu().numpy() if torch.is_tensor(seg) else np.asarray(seg)
            if border_size > 0:
                seg = seg[border_size : len(seg) - border_size]
            out[start + border_size : start + border_size + len(seg)] = seg
    return beat, downbeat


def split_predict_aggregate(spect, chunk_size: int, border_size: int, overlap_mode: str,
                            model: BeatThis, compute_dtype: torch.dtype = torch.float32) -> dict:
    """Framewise {"beat", "downbeat"} logits of a whole (T, F) piece through
    `ChunkedPredictor` with "keep_first" or "keep_last" overlap handling
    (reference beat_this/inference.py:188-230)."""
    predictor = ChunkedPredictor(model, chunk_size, border_size, compute_dtype,
                                 overlap_mode=overlap_mode)
    beat, downbeat = predictor.predict(np.asarray(spect))
    return {"beat": beat, "downbeat": downbeat}


def _pad_logit_group(logits):
    """Per-piece (beat, downbeat) logit pairs of ragged lengths as padded
    (n, t_max) arrays plus the validity mask the batched postprocessor
    takes (padding at -1000 can never cross the 0-logit peak threshold)."""
    t_max = max(len(b) for b, _ in logits)
    n = len(logits)
    beat = np.full((n, t_max), -1000.0, np.float32)
    down = np.full((n, t_max), -1000.0, np.float32)
    mask = np.zeros((n, t_max), bool)
    for i, (b, d) in enumerate(logits):
        beat[i, : len(b)] = b
        down[i, : len(d)] = d
        mask[i, : len(b)] = True
    return beat, down, mask


def predict_postprocess_batched(predictor: ChunkedPredictor, postprocessor, pieces,
                                group_size: int = 32):
    """Stream (piece, beat_times, downbeat_times) over an iterable of piece
    dicts (each with a "spect"), `group_size` pieces per batched forward
    (`predict_many`) and batched postprocess; the results are those of the
    per-piece path."""

    def flush(group):
        logits = predictor.predict_many([p["spect"] for p in group])
        beat_times, down_times = postprocessor(*_pad_logit_group(logits))
        yield from zip(group, beat_times, down_times)

    group = []
    for piece in pieces:
        group.append(piece)
        if len(group) == group_size:
            yield from flush(group)
            group = []
    if group:
        yield from flush(group)


class Spect2Frames:
    """Framewise beat/downbeat logits from a (T, 128) log-mel spectrogram.
    `checkpoint_path` is a local path, URL or released shortname (None: a
    freshly initialized default model). `device` defaults to CUDA; pass
    "cpu" to run on the CPU. `float16` selects bfloat16 compute."""

    def __init__(self, checkpoint_path="final0", device="cuda", float16=False,
                 chunk_size=CHUNK_SIZE, border_size=BORDER_SIZE):
        self.device = resolve_device(device)
        self.float16 = float16
        self.model = load_model(checkpoint_path, self.device)
        self.predictor = ChunkedPredictor(
            self.model, chunk_size, border_size,
            compute_dtype=torch.bfloat16 if float16 else torch.float32,
        )

    def spect2frames(self, spect):
        return self.predictor.predict(np.asarray(spect))

    def __call__(self, spect):
        return self.spect2frames(spect)


def _pad_wave_for_mel(signal: np.ndarray) -> np.ndarray:
    """The signal followed by the reflection of its last min(512, n - 1)
    samples, then zeros, to n + 512 samples: exactly the samples the JAX
    package's bucket-padded mel input holds where the kept frames read it
    (beat_this_tpu/inference.py:_pad_wave_for_mel), so the two agree also
    for signals of 512 samples or fewer, where reflect padding of the bare
    signal is undefined."""
    n = len(signal)
    out = np.zeros(n + 512, np.float32)
    out[:n] = signal
    reflect = min(512, n - 1)
    if reflect > 0:
        stop = n - 2 - reflect
        out[n : n + reflect] = signal[n - 2 : (stop if stop >= 0 else None) : -1]
    return out


class Audio2Frames(Spect2Frames):
    """Framewise logits from an audio waveform at any sample rate."""

    def signal2spect(self, signal, sr):
        signal = np.asarray(signal)
        if signal.ndim == 2:
            signal = signal.mean(1)
        elif signal.ndim != 1:
            raise ValueError(f"Expected 1D or 2D signal, got shape {signal.shape}")
        if sr != 22050:
            from beat_this_tpu_torch.ops.resample import resample

            signal = resample(signal, in_rate=sr, out_rate=22050)
        frames = num_frames(len(signal))
        wave = torch.from_numpy(_pad_wave_for_mel(signal.astype(np.float32)))
        spect = log_mel_spectrogram(wave.to(self.device), LogMelConfig())
        return spect[:frames].cpu().numpy()

    def __call__(self, signal, sr):
        return self.spect2frames(self.signal2spect(signal, sr))


class Audio2Beats(Audio2Frames):
    """Beat and downbeat times (seconds) from an audio waveform. `dbn`
    selects the DBN decoder (`postprocessing/dbn.py`) instead of peak
    picking."""

    def __init__(self, checkpoint_path="final0", device="cuda", float16=False, dbn=False,
                 chunk_size=CHUNK_SIZE, border_size=BORDER_SIZE):
        self.frames2beats = Postprocessor(
            type="dbn" if dbn else "minimal", device=resolve_device(device)
        )
        super().__init__(checkpoint_path, device, float16, chunk_size, border_size)

    def __call__(self, signal, sr):
        return self.frames2beats(*super().__call__(signal, sr))


class File2Beats(Audio2Beats):
    def __call__(self, audio_path):
        signal, sr = load_audio(audio_path)
        return super().__call__(signal, sr)


class File2File(File2Beats):
    def __call__(self, audio_path, output_path):
        beats, downbeats = super().__call__(audio_path)
        save_beat_tsv(beats, downbeats, output_path)


def _try_call(fn, *args):
    try:
        return fn(*args), None
    except Exception as exc:  # noqa: BLE001 - reported per file by the caller
        return None, exc


class BatchedFile2File(File2File):
    """Directory-scale inference: groups of `group_size` files are loaded
    together, share one batched forward (`predict_many`) and one batched
    postprocess, and write the `.beats` files the per-file path writes."""

    def __init__(self, checkpoint_path="final0", device="cuda", float16=False, dbn=False,
                 group_size=8):
        super().__init__(checkpoint_path, device, float16, dbn)
        self.group_size = group_size

    def _decode_group(self, spects):
        """Per spectrogram ((logits, (beats, downbeats)), None) from one
        batched forward and postprocess. If the group fails, each file runs
        alone and a failing one gives (None, exception): one bad file must
        not stop the run, nor take its group along."""
        try:
            logits = self.predictor.predict_many(spects)
            times = zip(*self.frames2beats(*_pad_logit_group(logits)))
            return [((lg, t), None) for lg, t in zip(logits, times)]
        except Exception:  # noqa: BLE001 - reported per file below
            def alone(spect):
                logits = self.predictor.predict(spect)
                return logits, self.frames2beats(*logits)

            return [_try_call(alone, spect) for spect in spects]

    def process_many(self, tasks, on_error=None, after_each=None) -> float:
        """tasks: iterable of (audio_path, output_path). A file that fails
        to load or to process calls `on_error(path, exception)` and is
        skipped; `after_each(path, output_path, beat_logits,
        downbeat_logits)` follows each written file. Returns the seconds of
        audio processed."""
        tasks = list(tasks)
        seconds = 0.0
        for i in range(0, len(tasks), self.group_size):
            group = tasks[i : i + self.group_size]
            # decoding overlaps across files; the mel runs on the device in turn
            with ThreadPoolExecutor() as pool:
                loaded = list(pool.map(lambda t: _try_call(load_audio, t[0]), group))
            spects, valid = [], []
            for (path, out), (audio, err) in zip(group, loaded):
                if err is None:
                    spect, err = _try_call(self.signal2spect, *audio)
                if err is not None:
                    if on_error:
                        on_error(path, err)
                    continue
                seconds += len(audio[0]) / audio[1]
                spects.append(spect)
                valid.append((path, out))
            if not spects:
                continue
            for (path, out), (decoded, err) in zip(valid, self._decode_group(spects)):
                try:
                    if err is not None:
                        raise err
                    (beat_logits, downbeat_logits), (beats, downbeats) = decoded
                    save_beat_tsv(beats, downbeats, out)
                    if after_each:
                        after_each(path, out, beat_logits, downbeat_logits)
                except Exception as exc:  # noqa: BLE001 - one bad file must not stop the run
                    if on_error:
                        on_error(path, exc)
        return seconds

