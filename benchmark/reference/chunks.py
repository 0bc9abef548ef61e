"""The reference's chunk rule (beat_this/inference.py:100-185): a piece is
cut into chunks of 1500 frames every 1488 (a border of 6 frames on each
side), the first starting 6 frames before the piece and the last shifted to
end 6 frames after it, zero outside the piece; each chunk's logits without
its borders are stitched back, an earlier chunk winning where two overlap.
A piece of at most 1488 frames runs whole, with 6 zero frames on each side.
The program pads such a window to its time bucket and masks it; the
reference runs it at its own length."""

from __future__ import annotations

import numpy as np
import torch

CHUNK, BORDER = 1500, 6
STRIDE = CHUNK - 2 * BORDER


def starts(t: int) -> np.ndarray:
    s = np.arange(-BORDER, t - BORDER, STRIDE)
    if t > STRIDE:
        s[-1] = t - (CHUNK - BORDER)
    return s


def own_windows(t: int) -> list[int]:
    """The frames of each forward row the reference runs for a piece of `t`
    frames: the piece with its borders, or its chunks of 1500."""
    if t <= STRIDE:
        return [t + 2 * BORDER]
    return [CHUNK] * len(starts(t))


def cut(mel: torch.Tensor, s: int, length: int) -> torch.Tensor:
    """mel[s : s + length] with zero frames outside the piece."""
    t = len(mel)
    out = mel.new_zeros((length, mel.shape[1]))
    lo, hi = max(s, 0), min(s + length, t)
    if hi > lo:
        out[lo - s : hi - s] = mel[lo:hi]
    return out


def predict(model, mel: torch.Tensor, batch: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """(beat, downbeat) float32 logits (t,) of one piece's log-mel (t, 128)
    through `model.forward`, chunk by chunk."""
    t = len(mel)
    if t <= STRIDE:
        beat, down = model.forward(cut(mel, -BORDER, t + 2 * BORDER)[None])
        return (beat[0, BORDER : BORDER + t].cpu().numpy(),
                down[0, BORDER : BORDER + t].cpu().numpy())
    st = starts(t)
    outs = []
    for i in range(0, len(st), batch):
        x = torch.stack([cut(mel, int(s), CHUNK) for s in st[i : i + batch]])
        beat, down = model.forward(x)
        outs.append(torch.stack([beat, down]).cpu().numpy())
    logits = np.concatenate(outs, axis=1)  # (2, chunks, CHUNK)
    track = np.full((2, len(st) * STRIDE), -1000.0, np.float32)
    for i in reversed(range(len(st))):  # earlier chunks win: written last
        a = int(st[i]) + BORDER
        track[:, a : a + STRIDE] = logits[:, i, BORDER : CHUNK - BORDER]
    return track[0, :t], track[1, :t]
