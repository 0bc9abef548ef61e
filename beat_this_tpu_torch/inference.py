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

`ChunkedPredictor.predict_many_device` packs the chunks and short-piece
windows of several pieces, gathered from one log-mel on the model's device,
into shared forwards; `predict_many` uploads host spectrograms into such a
log-mel and runs it. `BatchedFile2File` runs a directory in groups: one
log-mel over the group's files packed into one flat signal on the model's
device, `predict_many_device` on it, one batched postprocess; all give what
the per-piece path gives. With a data-parallel `group` (`parallel/`), every
forward's rows are split over the ranks and the logits gathered to every
rank.
"""

from __future__ import annotations

import math
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from beat_this_tpu_torch.io.audio import load_audio, read_pcm16
from beat_this_tpu_torch.utils import save_beat_tsv
from beat_this_tpu_torch.io.checkpoint import init_beat_this, load_checkpoint, model_state_dict
from beat_this_tpu_torch.model.beat_this import BeatThis, BeatThisConfig
from beat_this_tpu_torch.ops.mel import LogMelConfig, log_mel_spectrogram, num_frames
from beat_this_tpu_torch.parallel.mesh import pad_to_multiple, shard_rows
from beat_this_tpu_torch.postprocessing.postprocessor import Postprocessor
from beat_this_tpu_torch.profiler import count, span

HOP = 441  # samples per log-mel frame
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
    """Chunked inference of one model on the model's device.

    `group`: an optional data-parallel `parallel.DataGroup` whose every rank
    runs the same calls on its copy of the model. Each forward's rows are
    then padded with zero rows to a multiple of the ranks, each rank runs
    its contiguous slice, and the logits are gathered to every rank as CPU
    tensors (single-program data-parallel inference, the counterpart of the
    JAX package's `mesh`); every rank returns every piece's logits."""

    def __init__(
        self,
        model: BeatThis,
        chunk_size: int = CHUNK_SIZE,
        border_size: int = BORDER_SIZE,
        compute_dtype: torch.dtype = torch.float32,
        overlap_mode: str = "keep_first",
        group=None,
    ):
        if overlap_mode not in ("keep_first", "keep_last"):
            raise ValueError(f"unknown overlap_mode: {overlap_mode!r}")
        self.model = model
        self.chunk_size = chunk_size
        self.border_size = border_size
        self.compute_dtype = compute_dtype
        self.overlap_mode = overlap_mode
        self.group = group if group is not None and group.distributed else None

    @property
    def stride(self) -> int:
        return self.chunk_size - 2 * self.border_size

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.inference_mode()
    def _forward(self, batch, valid_lengths=None):
        """Host logits of a (rows, T, bins) batch on the device; with a
        group, of the rank's slice, gathered from every rank. Counts the
        forward's rows x T frames and, for host `valid_lengths`, the frames
        masked past them (`profiler.counters`; with a group every rank
        counts the whole forward)."""
        x = torch.as_tensor(batch, device=self.device)
        rows, frames = x.shape[:2]
        masked = 0 if valid_lengths is None else int(rows * frames - np.sum(valid_lengths))
        count(forward_frames=rows * frames, masked_frames=masked)
        if valid_lengths is not None:
            valid_lengths = torch.as_tensor(valid_lengths, device=self.device)
        if self.group is not None:
            pad = pad_to_multiple(rows, self.group.world) - rows
            x = shard_rows(torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]), self.group)
            if valid_lengths is not None:
                valid_lengths = shard_rows(
                    torch.cat([valid_lengths, valid_lengths.new_full((pad,), x.shape[1])]),
                    self.group)
        with span("model"):
            out = self.model(x, valid_lengths=valid_lengths, compute_dtype=self.compute_dtype)
        logits = torch.stack([out["beat"], out["downbeat"]])
        with span("wait"):  # the host waits for the card here
            logits = logits.cpu()
        if self.group is not None:
            parts = [torch.empty_like(logits) for _ in range(self.group.world)]
            dist.all_gather(parts, logits, group=self.group.process_group)
            logits = torch.cat(parts, dim=1)[:, :rows]
        return logits[0].numpy(), logits[1].numpy()

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

    def predict_many(self, spects) -> list[tuple[np.ndarray, np.ndarray]]:
        """Several (T, mel_bins) pieces at once: uploaded as one tensor and run
        through `predict_many_device`, so the chunks of all long pieces share
        their forwards and the short pieces go through the time buckets
        together. Every row of a forward is computed on its own, so each
        piece gets the logits `predict` gives it."""
        spects = [np.asarray(s, dtype=np.float32) for s in spects]
        if not spects:
            return []
        nframes = [len(s) for s in spects]
        offsets = np.cumsum([0] + nframes[:-1]).tolist()
        mel = torch.from_numpy(np.concatenate(spects)).to(self.device)
        return self.predict_many_device(mel, offsets, nframes)

    def predict(self, spect: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """spect: (T, mel_bins) -> (beat_logits, downbeat_logits), each (T,)
        float32 numpy."""
        return self.predict_many([spect])[0]

    @staticmethod
    def _gather(mel: torch.Tensor, starts, lo, hi, rows: int) -> torch.Tensor:
        """Windows (len(starts), rows, bins) of the device-resident `mel`:
        window i holds mel[starts[i] + j] at its rows lo[i] <= j < hi[i] and
        exact zeros elsewhere."""
        dev = mel.device
        if len(mel) == 0:  # only empty pieces: every row is a zero row
            mel = mel.new_zeros(1, mel.shape[1])
        j = torch.arange(rows, device=dev)
        idx = torch.tensor(starts, device=dev)[:, None] + j
        lo, hi = (torch.tensor(b, device=dev)[:, None] for b in (lo, hi))
        keep = (j >= lo) & (j < hi)
        win = mel[idx.clamp(0, len(mel) - 1)]
        return torch.where(keep[..., None], win, torch.zeros((), dtype=mel.dtype, device=dev))

    def predict_many_device(self, mel: torch.Tensor, offsets, nframes
                            ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Logits of pieces that lie inside one (frames, bins) log-mel on the
        model's device, piece i at mel[offsets[i] : offsets[i] + nframes[i]]
        (`BatchedFile2File._batched_spects_device`, or `predict_many`'s
        upload). A piece of at most one stride runs as one window of
        T + 2 * border frames in its time bucket, masked by `valid_lengths`;
        a longer one as `plan_chunks`' chunks, stitched. The windows are
        gathered on the device, zero outside the piece, and packed into
        forwards of at most CHUNK_BATCH rows; the spectrogram never goes to
        the host."""
        with span("forward"):
            cs, bs, stride = self.chunk_size, self.border_size, self.stride
            n = len(offsets)
            short = [i for i in range(n) if nframes[i] <= stride]
            long = [i for i in range(n) if nframes[i] > stride]
            out: dict[int, tuple[np.ndarray, np.ndarray]] = {}

            # short pieces, by time bucket: window row j holds piece frame
            # j - bs, rows [bs, bs + t) are valid
            by_bucket: dict[int, list[int]] = {}
            for idx in short:
                padded_t = next(p for p in _time_buckets(cs) if p >= nframes[idx] + 2 * bs)
                by_bucket.setdefault(padded_t, []).append(idx)
            for padded_t, indices in by_bucket.items():
                for i in range(0, len(indices), CHUNK_BATCH):
                    rows = indices[i : i + CHUNK_BATCH]
                    batch = self._gather(mel, [offsets[r] - bs for r in rows], [bs] * len(rows),
                                         [bs + nframes[r] for r in rows], padded_t)
                    valid = np.array([nframes[r] + 2 * bs for r in rows], np.int64)
                    beat, down = self._forward(batch, valid)
                    for row, idx in enumerate(rows):
                        t = nframes[idx]
                        out[idx] = (beat[row, bs : bs + t], down[row, bs : bs + t])

            # long pieces: every chunk of every piece in order, packed; the
            # chunk at start s holds piece frames s + j for 0 <= s + j < t
            if long:
                plans = [plan_chunks(nframes[i], cs, bs) for i in long]
                windows = [(offsets[i] + s, max(s, 0) - s, min(s + cs, nframes[i]) - s)
                           for i, starts in zip(long, plans) for s in starts.tolist()]
                outs = [self._forward(self._gather(mel, *zip(*windows[i : i + CHUNK_BATCH]), cs))
                        for i in range(0, len(windows), CHUNK_BATCH)]
                beat = np.concatenate([o[0] for o in outs])
                down = np.concatenate([o[1] for o in outs])
                first = 0
                for idx, starts in zip(long, plans):
                    k = len(starts)
                    out[idx] = self._stitch(nframes[idx], starts + bs, beat[first : first + k],
                                            down[first : first + k])
                    first += k
            return [out[i] for i in range(n)]


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


def _as_pcm16_if_exact(x: np.ndarray) -> np.ndarray:
    """`x` as int16 PCM when every sample times 32768 is an integer of
    magnitude at most 32767 (audio decoded from 16-bit PCM, then only
    zero-padded, copied or averaged over equal channels), else `x`
    unchanged. Every 64th sample is looked at first, so resampled or
    float-source audio, which is not integral at that scale, declines
    after a small share of the passes."""
    for part in (x[::64], x):
        scaled = part.astype(np.float32) * np.float32(32768.0)
        rounded = np.round(scaled)
        if np.abs(rounded).max(initial=0.0) > 32767.0 or not np.array_equal(rounded, scaled):
            return x
    return rounded.astype(np.int16)


def pcm16_to_float(signal: np.ndarray) -> np.ndarray:
    """A signal of `BatchedFile2File._load_one` as float32: int16 PCM scaled
    by 1 / 32768 (exact, the value `load_audio` gives), anything else
    unchanged."""
    if signal.dtype == np.int16:
        return signal.astype(np.float32) * np.float32(1.0 / 32768.0)
    return signal


def pack_flat(signals) -> tuple[np.ndarray, list[int]]:
    """One flat signal holding every signal in a slot of its own, and the
    slots' first samples: int16 when every signal is int16 PCM (the log-mel
    undoes the scale exactly, so the group goes to the device in half the
    bytes), else float32. A slot is at least n + 1024 samples, a multiple
    of 4 hops: [signal | reflect tail | zeros], with the next slot's reflect
    head (the 512 samples the centered frames mirror at its left edge)
    written into the end of the zeros. A frame at global position f reads
    flat[f * 441 - 512 : f * 441 + 512], so every kept frame of a slot reads
    the samples `signal2spect` gives the log-mel of that signal alone (the
    first slot's head is the log-mel's own reflect padding)."""
    pcm = all(s.dtype == np.int16 for s in signals)
    if not pcm:
        signals = [pcm16_to_float(s) for s in signals]
    align = HOP * 4
    starts, pos = [], 0
    for s in signals:
        starts.append(pos)
        pos += math.ceil((len(s) + 1024) / align) * align
    flat = np.zeros(pos, np.int16 if pcm else np.float32)
    for st, s in zip(starts, signals):
        n = len(s)
        reflect = min(512, n - 1)
        flat[st : st + n] = s
        if reflect > 0:
            flat[st + n : st + n + reflect] = s[n - 1 - reflect : n - 1][::-1]
        if st:
            flat[st - 512 : st] = flat[st + 1 : st + 513][::-1]
    return flat, starts


class BatchedFile2File(File2File):
    """Directory-scale inference: groups of `group_size` files are loaded
    together, share one log-mel over their signals packed into one flat
    signal on the model's device, the forwards of `predict_many_device` on
    windows gathered there, and one batched postprocess, and write the
    `.beats` files the per-file path writes."""

    # groups that took the host path after the device path failed
    host_groups = 0

    def __init__(self, checkpoint_path="final0", device="cuda", float16=False, dbn=False,
                 group_size=8):
        super().__init__(checkpoint_path, device, float16, dbn)
        self.group_size = group_size

    @staticmethod
    def _load_one(audio_path) -> tuple[np.ndarray, float]:
        """A file's mono signal at 22050 Hz and its length in seconds: a 16-bit
        mono wav at 22050 Hz as its int16 samples, other audio as float32,
        or as int16 where `_as_pcm16_if_exact` finds it exact."""
        pcm = read_pcm16(audio_path)
        if pcm is not None and pcm[0].ndim == 1 and pcm[1] == 22050:
            return pcm[0], len(pcm[0]) / 22050
        signal, sr = load_audio(audio_path)
        signal = np.asarray(signal)
        seconds = len(signal) / sr
        if signal.ndim == 2:
            signal = signal.mean(1)
        if sr != 22050:
            from beat_this_tpu_torch.ops.resample import resample

            signal = resample(signal, in_rate=sr, out_rate=22050)
        return _as_pcm16_if_exact(signal.astype(np.float32)), seconds

    def _batched_spects_device(self, signals):
        """The group's log-mel as one (frames, bins) tensor on the model's
        device, from `pack_flat`'s signal, and each signal's (frame offset,
        frame count) in it."""
        with span("mel"):
            flat, starts = pack_flat(signals)
            with span("upload"):  # a pageable copy: the host waits for it
                flat = torch.from_numpy(flat).to(self.device)
            mel = log_mel_spectrogram(flat, LogMelConfig())
            return mel, [st // HOP for st in starts], [num_frames(len(s)) for s in signals]

    def _batched_spects(self, signals) -> list[np.ndarray]:
        """The group's log-mel of `_batched_spects_device`, downloaded and
        cut into one (frames, bins) array per signal."""
        mel, offsets, nframes = self._batched_spects_device(signals)
        mel = mel.cpu().numpy()
        return [mel[o : o + n] for o, n in zip(offsets, nframes)]

    def _group_logits(self, signals):
        """Per-signal (beat, downbeat) logits of one group: the device path
        (the group's log-mel stays on the device, `predict_many_device`). A
        failure there is printed on stderr and the group runs again on the
        host path (`predict_many` on `_batched_spects`), counted in
        `host_groups`."""
        try:
            return self.predictor.predict_many_device(*self._batched_spects_device(signals))
        except Exception as exc:  # noqa: BLE001 - reported, then the host path
            print(f"beat_this_tpu_torch: device-resident group inference failed with "
                  f"{type(exc).__name__}: {exc}; falling back to the host spect path for "
                  f"this group", file=sys.stderr)
            type(self).host_groups += 1
        return self.predictor.predict_many(self._batched_spects(signals))

    def _decode_group(self, signals):
        """Per signal ((logits, (beats, downbeats)), None) from one group
        forward and postprocess. If the group fails, each file runs alone
        and a failing one gives (None, exception): one bad file must not
        stop the run, nor take its group along."""
        try:
            logits = self._group_logits(signals)
            times = zip(*self.frames2beats(*_pad_logit_group(logits)))
            return [((lg, t), None) for lg, t in zip(logits, times)]
        except Exception:  # noqa: BLE001 - reported per file below
            def alone(signal):
                logits = self.spect2frames(self.signal2spect(pcm16_to_float(signal), 22050))
                return logits, self.frames2beats(*logits)

            return [_try_call(alone, signal) for signal in signals]

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
            before = seconds
            with span("group") as unit:
                # decoding and resampling overlap across files
                with span("load"), ThreadPoolExecutor() as pool:
                    loaded = list(pool.map(lambda t: _try_call(self._load_one, t[0]), group))
                signals, valid = [], []
                for (path, out), (audio, err) in zip(group, loaded):
                    if err is not None:
                        if on_error:
                            on_error(path, err)
                        continue
                    seconds += audio[1]
                    signals.append(audio[0])
                    valid.append((path, out))
                unit.set(seconds - before)
                if not signals:
                    continue
                for (path, out), (decoded, err) in zip(valid, self._decode_group(signals)):
                    try:
                        if err is not None:
                            raise err
                        (beat_logits, downbeat_logits), (beats, downbeats) = decoded
                        with span("write"):
                            save_beat_tsv(beats, downbeats, out)
                        if after_each:
                            after_each(path, out, beat_logits, downbeat_logits)
                    except Exception as exc:  # noqa: BLE001 - one bad file must not stop the run
                        if on_error:
                            on_error(path, exc)
        return seconds

