"""Audio file loading with a backend cascade.

Equivalent of the reference loader (beat_this/preprocessing.py:6-24), with a
native RIFF/WAVE parser first (PCM 8/16/24/32-bit and IEEE float, mono or
multichannel) so the framework has zero audio dependencies for the common
case, then optional `soundfile`, then an `ffmpeg` subprocess for compressed
formats. Returns (waveform, samplerate): mono files give shape (T,),
multichannel (T, C), values in [-1, 1] as the requested dtype.

The port's copy of beat_this_tpu/io/audio.py, kept so that the port imports nothing of
the JAX package; the tests hold the two to identical results.
"""

from __future__ import annotations

import io
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np


def _parse_wav(path):
    """(format tag, channels, samplerate, bits per sample, sample bytes) of a
    RIFF/WAVE file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            if fmt[0] == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                (subformat,) = struct.unpack("<H", body[24:26])
                fmt = (subformat,) + fmt[1:]
        elif chunk_id == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or payload is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, samplerate, _, _, bits = fmt
    return audio_format, channels, samplerate, bits, payload


def _read_wav(path, dtype="float64"):
    audio_format, channels, samplerate, bits, payload = _parse_wav(path)
    if audio_format == 1:  # integer PCM
        if bits == 8:
            x = data_u8 = np.frombuffer(payload, dtype=np.uint8)
            x = (data_u8.astype(np.float64) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(payload, dtype="<i2").astype(np.float64) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
            as32 = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
            x = as32.astype(np.float64) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(payload, dtype="<i4").astype(np.float64) / float(1 << 31)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(payload, dtype="<f4").astype(np.float64)
        elif bits == 64:
            x = np.frombuffer(payload, dtype="<f8").astype(np.float64)
        else:
            raise ValueError(f"unsupported float bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAVE format tag {audio_format}")
    if channels > 1:
        x = x.reshape(-1, channels)
    return np.asarray(x, dtype=dtype), samplerate


def read_pcm16(path):
    """(int16 samples, samplerate) of a 16-bit PCM WAVE file, shaped as
    `load_audio` shapes them: the integers it divides by 32768. None for
    any other file."""
    try:
        audio_format, channels, samplerate, bits, payload = _parse_wav(path)
        if audio_format != 1 or bits != 16:
            return None
        x = np.frombuffer(payload, dtype=np.dtype("<i2"))
    except (OSError, ValueError, struct.error):
        return None
    return (x.reshape(-1, channels) if channels > 1 else x), samplerate


def _read_via_ffmpeg(path, dtype="float64"):
    ffprobe = shutil.which("ffprobe")
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        raise RuntimeError("ffmpeg not available")
    samplerate = 44100
    if ffprobe:
        out = subprocess.run(
            [ffprobe, "-v", "quiet", "-show_entries", "stream=sample_rate",
             "-of", "csv=p=0", str(path)],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()
        if out and out[0].isdigit():
            samplerate = int(out[0])
    raw = subprocess.run(
        [ffmpeg, "-v", "quiet", "-i", str(path), "-f", "f64le",
         "-ar", str(samplerate), "-"],
        capture_output=True, check=True,
    ).stdout
    x = np.frombuffer(raw, dtype="<f8")
    return np.asarray(x, dtype=dtype), samplerate


def load_audio(path, dtype="float64"):
    """Load an audio file -> (waveform, samplerate). Tries the built-in WAV
    parser, then soundfile, then ffmpeg (reference cascade:
    beat_this/preprocessing.py:6-24)."""
    errors = []
    try:
        return _read_wav(path, dtype)
    except Exception as e:  # noqa: BLE001 - cascade by design
        errors.append(f"wav: {e}")
    try:
        import soundfile as sf

        return sf.read(path, dtype=dtype)
    except Exception as e:  # noqa: BLE001
        errors.append(f"soundfile: {e}")
    try:
        return _read_via_ffmpeg(path, dtype)
    except Exception as e:  # noqa: BLE001
        errors.append(f"ffmpeg: {e}")
    raise RuntimeError(
        f'Could not load audio from "{path}". Backend errors: {"; ".join(errors)}'
    )


def save_wav(path, waveform, samplerate, bits_per_sample=16):
    """Write a PCM WAV file (used by the offline preprocessing pipeline,
    mirroring reference launch_scripts/preprocess_audio.py:24-34)."""
    x = np.asarray(waveform, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    channels = x.shape[1]
    if bits_per_sample == 16:
        data = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2").tobytes()
        fmt_tag, bits = 1, 16
    elif bits_per_sample == 32:
        data = x.astype("<f4").tobytes()
        fmt_tag, bits = 3, 32
    else:
        raise ValueError("bits_per_sample must be 16 or 32")
    byte_rate = samplerate * channels * bits // 8
    block_align = channels * bits // 8
    header = io.BytesIO()
    header.write(b"RIFF")
    header.write(struct.pack("<I", 36 + len(data)))
    header.write(b"WAVEfmt ")
    header.write(
        struct.pack("<IHHIIHH", 16, fmt_tag, channels, samplerate, byte_rate,
                    block_align, bits)
    )
    header.write(b"data")
    header.write(struct.pack("<I", len(data)))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        with open(path, "wb") as f:
            f.write(header.getvalue())
            f.write(data)
    except KeyboardInterrupt:
        path.unlink()  # avoid half-written files
        raise
