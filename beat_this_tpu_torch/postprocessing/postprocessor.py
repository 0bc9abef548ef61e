"""Framewise logits to beat and downbeat times, counterpart of
beat_this_tpu/postprocessing/postprocessor.py.

Two modes, as in the reference (beat_this/model/postprocessor.py:9-173):
"minimal" is strict local-maximum peak picking (`ops/pool.peak_pick`, on the
given device), then the host tail copied from the JAX package
(adjacent-peak deduplication, downbeat-to-beat snapping); "dbn" is the
madmom DBNDownBeatTrackingProcessor equivalent, a batched Viterbi pass on
the given device (`postprocessing/dbn.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from beat_this_tpu_torch.ops.pool import peak_pick
from beat_this_tpu_torch.profiler import span


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
        type: "minimal" or "dbn".
        fps: frames per second of the model output.
        device: where peak picking and the DBN's Viterbi passes run.
    """

    def __init__(self, type: str = "minimal", fps: int = 50, device="cpu"):
        if type not in ("minimal", "dbn"):
            raise ValueError("Invalid postprocessing type")
        self.type = type
        self.fps = fps
        self.device = device
        if type == "dbn":
            from beat_this_tpu_torch.postprocessing.dbn import DbnDecoder

            self.dbn = DbnDecoder(
                beats_per_bar=(3, 4),
                min_bpm=55.0,
                max_bpm=215.0,
                fps=fps,
                transition_lambda=100.0,
                device=device,
            )

    def __call__(self, beat, downbeat, padding_mask=None):
        with span("post"):
            beat = np.asarray(beat, dtype=np.float32)
            downbeat = np.asarray(downbeat, dtype=np.float32)
            batched = beat.ndim != 1
            if padding_mask is None:
                padding_mask = np.ones_like(beat, dtype=bool)
            else:
                padding_mask = np.asarray(padding_mask).astype(bool)
            if not batched:
                beat, downbeat, padding_mask = beat[None], downbeat[None], padding_mask[None]
            if self.type == "minimal":
                out_beat, out_downbeat = self.postp_minimal(beat, downbeat, padding_mask)
            else:
                out_beat, out_downbeat = self.postp_dbn(beat, downbeat, padding_mask)
            if not batched:
                return out_beat[0], out_downbeat[0]
            return out_beat, out_downbeat

    def postp_minimal(self, beat, downbeat, padding_mask):
        stacked = torch.from_numpy(np.stack([beat, downbeat])).to(self.device)
        mask = torch.from_numpy(np.broadcast_to(padding_mask[None], stacked.shape).copy())
        peaks = peak_pick(stacked, mask.to(self.device))
        with span("wait"):  # the host waits for the card here
            peaks = peaks.cpu().numpy()  # (2, B, T)
        results = [
            self._postp_minimal_item(b, d, m)
            for b, d, m in zip(peaks[0], peaks[1], padding_mask)
        ]
        out_beat, out_downbeat = zip(*results)
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

    def postp_dbn(self, beat, downbeat, padding_mask):
        """Logits to probabilities clamped away from 0 and 1 (reference
        beat_this/model/postprocessor.py:138-151), then every piece through
        one batched decode. Batched eval pads short pieces with -1000
        logits, whose exp overflows to inf: the probability 0 is right and
        masked."""
        with np.errstate(over="ignore"):
            beat_prob = 1.0 / (1.0 + np.exp(-beat.astype(np.float64)))
            downbeat_prob = 1.0 / (1.0 + np.exp(-downbeat.astype(np.float64)))
        epsilon = 1e-5
        beat_prob = beat_prob * (1 - epsilon) + epsilon / 2
        downbeat_prob = downbeat_prob * (1 - epsilon) + epsilon / 2
        combined = [
            self._combined_activations(b, d, m)
            for b, d, m in zip(beat_prob, downbeat_prob, padding_mask)
        ]
        out_beat, out_downbeat = [], []
        for dbn_out in self.dbn.decode_many(combined):
            out_beat.append(dbn_out[:, 0])
            out_downbeat.append(dbn_out[dbn_out[:, 1] == 1][:, 0])
        return tuple(out_beat), tuple(out_downbeat)

    @staticmethod
    def _combined_activations(beat_prob, downbeat_prob, mask):
        """Böck-style combined activation matrix (reference
        beat_this/model/postprocessor.py:153-168)."""
        beat_prob = beat_prob[mask]
        downbeat_prob = downbeat_prob[mask]
        epsilon = 1e-5
        return np.stack(
            [np.maximum(beat_prob - downbeat_prob, epsilon / 2), downbeat_prob],
            axis=1,
        )

