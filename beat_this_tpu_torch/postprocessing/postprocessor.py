"""Framewise logits to beat and downbeat times, counterpart of
beat_this_tpu/postprocessing/postprocessor.py.

"minimal" only: strict local-maximum peak picking (`ops/pool.peak_pick`, on
the given device), then the host tail copied from the JAX package
(adjacent-peak deduplication, downbeat-to-beat snapping). The DBN decoder
is not ported yet (ROADMAP.md queue A4).
"""

from __future__ import annotations

import numpy as np
import torch

from beat_this_tpu_torch.ops.pool import peak_pick


def _merge_close_peaks(group: np.ndarray, width: float) -> list:
    """A peak joins the open cluster while it lies within `width` of the
    cluster's mean; (sum, count) keeps the arithmetic exact."""
    means = []
    acc = 0.0
    n = 0
    for q in group:
        if n and q * n - acc > width * n:  # q - acc/n > width, without division
            means.append(acc / n)
            acc, n = 0.0, 0
        acc += q
        n += 1
    means.append(acc / n)
    return means


def deduplicate_peaks(peaks, width=1) -> np.ndarray:
    """Collapse clusters of near-coincident peaks into their mean position
    (reference beat_this/model/postprocessor.py:176-197): a coarse split
    wherever consecutive peaks are more than `width` apart, then the exact
    mean-distance rule inside groups of three or more."""
    peaks = np.asarray(list(peaks), dtype=np.float64)
    if peaks.size == 0:
        return np.array([])
    cut_after = np.flatnonzero(np.diff(peaks) > width)
    out = []
    for group in np.split(peaks, cut_after + 1):
        if group.size == 1:
            out.append(group[0])
        elif group.size == 2:
            out.append(0.5 * (group[0] + group[1]))
        else:
            out.extend(_merge_close_peaks(group, width))
    return np.asarray(out)


class Postprocessor:
    """Convert framewise beat/downbeat logits to times in seconds.

    Args:
        type: "minimal" ("dbn" is not ported yet and raises).
        fps: frames per second of the model output.
        device: where peak picking runs.
    """

    def __init__(self, type: str = "minimal", fps: int = 50, device="cpu"):
        if type == "dbn":
            raise NotImplementedError(
                "the DBN postprocessor is not ported to PyTorch yet (ROADMAP.md "
                "queue A4); use the minimal postprocessor"
            )
        if type != "minimal":
            raise ValueError("Invalid postprocessing type")
        self.type = type
        self.fps = fps
        self.device = device

    def __call__(self, beat, downbeat, padding_mask=None):
        beat = np.asarray(beat, dtype=np.float32)
        downbeat = np.asarray(downbeat, dtype=np.float32)
        batched = beat.ndim != 1
        if padding_mask is None:
            padding_mask = np.ones_like(beat, dtype=bool)
        else:
            padding_mask = np.asarray(padding_mask).astype(bool)
        if not batched:
            beat, downbeat, padding_mask = beat[None], downbeat[None], padding_mask[None]
        stacked = torch.from_numpy(np.stack([beat, downbeat])).to(self.device)
        mask = torch.from_numpy(np.broadcast_to(padding_mask[None], stacked.shape).copy())
        peaks = peak_pick(stacked, mask.to(self.device)).cpu().numpy()  # (2, B, T)
        results = [
            self._postp_minimal_item(b, d, m)
            for b, d, m in zip(peaks[0], peaks[1], padding_mask)
        ]
        out_beat, out_downbeat = zip(*results)
        if not batched:
            return out_beat[0], out_downbeat[0]
        return tuple(out_beat), tuple(out_downbeat)

    def _postp_minimal_item(self, beat_peaks, downbeat_peaks, mask):
        """Host tail per piece (reference beat_this/model/postprocessor.py:113-136)."""
        beat_frame = np.flatnonzero(beat_peaks[mask])
        downbeat_frame = np.flatnonzero(downbeat_peaks[mask])
        beat_frame = deduplicate_peaks(beat_frame, width=1)
        downbeat_frame = deduplicate_peaks(downbeat_frame, width=1)
        beat_time = beat_frame / self.fps
        downbeat_time = downbeat_frame / self.fps
        if len(beat_time) > 0:
            # snap each downbeat to its nearest beat
            for i, d_time in enumerate(downbeat_time):
                beat_idx = np.argmin(np.abs(beat_time - d_time))
                downbeat_time[i] = beat_time[beat_idx]
        downbeat_time = np.unique(downbeat_time)
        return beat_time, downbeat_time
