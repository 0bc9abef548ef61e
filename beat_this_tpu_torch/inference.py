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
"""

from __future__ import annotations

import numpy as np
import torch

from beat_this_tpu.io.audio import load_audio
from beat_this_tpu.utils import save_beat_tsv
from beat_this_tpu_torch.io.checkpoint import load_checkpoint, model_state_dict
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


def load_model(checkpoint_path, device) -> BeatThis:
    """A BeatThis module in eval mode on `device`, from a local checkpoint
    file (reference beat_this/inference.py:56-87)."""
    device = resolve_device(device)
    checkpoint = load_checkpoint(checkpoint_path)
    config = BeatThisConfig.from_hparams(checkpoint.get("hyper_parameters", {}))
    with torch.device(device):
        model = BeatThis(config)
    model.load_state_dict(model_state_dict(checkpoint))
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

    def _predict_short(self, spect: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One chunk of T + 2 * border frames, padded to a time bucket."""
        bs, t = self.border_size, len(spect)
        valid = t + 2 * bs
        padded_t = next(p for p in _time_buckets(self.chunk_size) if p >= valid)
        batch = np.zeros((1, padded_t, spect.shape[1]), np.float32)
        batch[0, bs : bs + t] = spect
        beat, down = self._forward(batch, np.array([valid], np.int64))
        return beat[0, bs : bs + t], down[0, bs : bs + t]

    def predict(self, spect: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """spect: (T, mel_bins) -> (beat_logits, downbeat_logits), each (T,)
        float32 numpy."""
        spect = np.asarray(spect, dtype=np.float32)
        t = spect.shape[0]
        if t <= self.stride:
            return self._predict_short(spect)
        cs, bs, stride = self.chunk_size, self.border_size, self.stride
        starts = plan_chunks(t, cs, bs) + bs  # in padded coordinates
        padded = np.zeros((len(starts) * stride + 2 * bs, spect.shape[1]), np.float32)
        padded[bs : bs + t] = spect
        chunks = np.stack([padded[s : s + cs] for s in starts])
        outs = [
            self._forward(chunks[i : i + CHUNK_BATCH])
            for i in range(0, len(chunks), CHUNK_BATCH)
        ]
        beat = np.concatenate([o[0] for o in outs])
        down = np.concatenate([o[1] for o in outs])
        buf_b = np.full(len(starts) * stride, -1000.0, np.float32)
        buf_d = np.full(len(starts) * stride, -1000.0, np.float32)
        order = range(len(starts))
        if self.overlap_mode == "keep_first":
            order = reversed(order)  # later writes win, so write the winners last
        for i in order:
            buf_b[starts[i] : starts[i] + stride] = beat[i, bs : cs - bs]
            buf_d[starts[i] : starts[i] + stride] = down[i, bs : cs - bs]
        return buf_b[:t], buf_d[:t]


class Spect2Frames:
    """Framewise beat/downbeat logits from a (T, 128) log-mel spectrogram.
    `device` defaults to CUDA; pass "cpu" to run on the CPU. `float16`
    selects bfloat16 compute."""

    def __init__(self, checkpoint_path, device="cuda", float16=False,
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
            from beat_this_tpu.ops.resample import resample

            signal = resample(signal, in_rate=sr, out_rate=22050)
        frames = num_frames(len(signal))
        wave = torch.from_numpy(_pad_wave_for_mel(signal.astype(np.float32)))
        spect = log_mel_spectrogram(wave.to(self.device), LogMelConfig())
        return spect[:frames].cpu().numpy()

    def __call__(self, signal, sr):
        return self.spect2frames(self.signal2spect(signal, sr))


class Audio2Beats(Audio2Frames):
    """Beat and downbeat times (seconds) from an audio waveform. `dbn=True`
    raises: the DBN decoder is not ported yet (ROADMAP.md queue A4)."""

    def __init__(self, checkpoint_path, device="cuda", float16=False, dbn=False,
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
