"""Beat-tracking evaluation metrics, dependency-free.

Re-implements the mir_eval.beat metrics the reference relies on
(reference: beat_this/model/pl_module.py:320-339): F-measure (0.07 s window,
maximum bipartite matching), Cemgil accuracy (sigma 0.04, plus the max over
metrical variations), and the continuity-based CMLc/CMLt/AMLc/AMLt (phase
and period tolerance 0.175), all after trimming beats earlier than 5 s.
Algorithms follow the published definitions used by mir_eval (Davies, Degara
& Plumbley, "Evaluation Methods for Musical Audio Beat Tracking Algorithms",
C4DM TR-09-06) including its edge-case conventions.

The port's copy of beat_this_tpu/metrics.py, kept so that the port imports nothing of
the JAX package; the tests hold the two to identical results.
"""

from __future__ import annotations

import numpy as np


def trim_beats(beats: np.ndarray, min_beat_time: float = 5.0) -> np.ndarray:
    """Drop beats earlier than `min_beat_time` seconds (mir_eval convention
    used via eval_trim_beats=5, reference pl_module.py:324-326)."""
    beats = np.asarray(beats, dtype=np.float64)
    return beats[beats >= min_beat_time]


def _maximum_matching(ref: np.ndarray, est: np.ndarray, window: float) -> int:
    """Size of the maximum bipartite matching between reference and estimated
    events with |r - e| <= window (augmenting-path algorithm; sizes are a few
    hundred, so O(V*E) is plenty fast)."""
    # candidate edges, ref-side adjacency
    adj: list[list[int]] = []
    for r in ref:
        lo = np.searchsorted(est, r - window, side="left")
        hi = np.searchsorted(est, r + window, side="right")
        adj.append(list(range(lo, hi)))
    match_est = {}
    match_ref = {}

    def try_augment(i, visited):
        for j in adj[i]:
            if j in visited:
                continue
            visited.add(j)
            if j not in match_est or try_augment(match_est[j], visited):
                match_est[j] = i
                match_ref[i] = j
                return True
        return False

    for i in range(len(ref)):
        try_augment(i, set())
    return len(match_est)


def f_measure(
    reference_beats: np.ndarray,
    estimated_beats: np.ndarray,
    f_measure_threshold: float = 0.07,
) -> float:
    """Beat F-measure with a +/-70 ms matching window."""
    reference_beats = np.asarray(reference_beats, dtype=np.float64)
    estimated_beats = np.asarray(estimated_beats, dtype=np.float64)
    if reference_beats.size == 0 or estimated_beats.size == 0:
        return 0.0
    matching = _maximum_matching(
        reference_beats, np.sort(estimated_beats), f_measure_threshold
    )
    if matching == 0:
        return 0.0
    precision = matching / len(estimated_beats)
    recall = matching / len(reference_beats)
    return 2.0 * precision * recall / (precision + recall)


def _reference_beat_variations(reference_beats: np.ndarray):
    """Metrical variations: original, off-beat, double tempo, half tempo
    (odd), half tempo (even)."""
    interpolated_indices = np.arange(0, reference_beats.shape[0] - 0.5, 0.5)
    original_indices = np.arange(0, reference_beats.shape[0])
    double_beats = np.interp(interpolated_indices, original_indices, reference_beats)
    return (
        reference_beats,
        double_beats[1::2],
        double_beats,
        reference_beats[::2],
        reference_beats[1::2],
    )


def cemgil(
    reference_beats: np.ndarray,
    estimated_beats: np.ndarray,
    cemgil_sigma: float = 0.04,
) -> tuple[float, float]:
    """Cemgil accuracy: Gaussian-windowed nearest-beat score, normalized by
    the mean count; returns (score, max over metrical variations)."""
    reference_beats = np.asarray(reference_beats, dtype=np.float64)
    estimated_beats = np.asarray(estimated_beats, dtype=np.float64)
    if reference_beats.size == 0 or estimated_beats.size == 0:
        return 0.0, 0.0
    accuracies = []
    for ref in _reference_beat_variations(reference_beats):
        accuracy = 0.0
        for beat in ref:
            beat_diff = np.min(np.abs(beat - estimated_beats))
            accuracy += np.exp(-(beat_diff**2) / (2.0 * cemgil_sigma**2))
        accuracy /= 0.5 * (len(estimated_beats) + len(ref))
        accuracies.append(accuracy)
    return accuracies[0], float(np.max(accuracies))


def _continuity_one(
    reference_beats: np.ndarray,
    estimated_beats: np.ndarray,
    phase_threshold: float,
    period_threshold: float,
) -> tuple[float, float]:
    """(continuous, total) accuracy for one reference variation."""
    n_annotations = max(len(reference_beats), len(estimated_beats))
    used = np.zeros(len(reference_beats), dtype=bool)
    successes = np.zeros(len(estimated_beats), dtype=bool)
    for m in range(len(estimated_beats)):
        differences = np.abs(estimated_beats[m] - reference_beats)
        nearest = int(np.argmin(differences))
        min_difference = differences[nearest]
        if used[nearest]:
            continue
        if m == 0 or nearest == 0:
            # look forward at the start of either sequence
            if nearest + 1 < len(reference_beats):
                reference_interval = (
                    reference_beats[nearest + 1] - reference_beats[nearest]
                )
            else:
                reference_interval = (
                    reference_beats[nearest] - reference_beats[nearest - 1]
                )
            if m + 1 < len(estimated_beats):
                estimated_interval = estimated_beats[m + 1] - estimated_beats[m]
            else:
                estimated_interval = estimated_beats[m] - estimated_beats[m - 1]
        else:
            reference_interval = (
                reference_beats[nearest] - reference_beats[nearest - 1]
            )
            estimated_interval = estimated_beats[m] - estimated_beats[m - 1]
        if reference_interval == 0:
            phase = 1.0 if min_difference == 0 else np.inf
            period = 0.0 if estimated_interval == 0 else np.inf
        else:
            phase = abs(min_difference / reference_interval)
            period = abs(1.0 - estimated_interval / reference_interval)
        if phase < phase_threshold and period < period_threshold:
            used[nearest] = True
            successes[m] = True
    # streak lengths of consecutive successes
    padded = np.concatenate([[0], successes.astype(int), [0]])
    failures = np.flatnonzero(padded == 0)
    streaks = np.diff(failures) - 1
    streaks = streaks[streaks > 0]
    longest = int(streaks.max()) if streaks.size else 0
    total = int(streaks.sum())
    return longest / n_annotations, total / n_annotations


def continuity(
    reference_beats: np.ndarray,
    estimated_beats: np.ndarray,
    continuity_phase_threshold: float = 0.175,
    continuity_period_threshold: float = 0.175,
) -> tuple[float, float, float, float]:
    """Continuity metrics (CMLc, CMLt, AMLc, AMLt)."""
    reference_beats = np.asarray(reference_beats, dtype=np.float64)
    estimated_beats = np.asarray(estimated_beats, dtype=np.float64)
    if reference_beats.size < 2 or estimated_beats.size < 2:
        return 0.0, 0.0, 0.0, 0.0
    continuous_accuracies = []
    total_accuracies = []
    for variation in _reference_beat_variations(reference_beats):
        if variation.size < 2:
            continuous_accuracies.append(0.0)
            total_accuracies.append(0.0)
            continue
        c, t = _continuity_one(
            variation,
            estimated_beats,
            continuity_phase_threshold,
            continuity_period_threshold,
        )
        continuous_accuracies.append(c)
        total_accuracies.append(t)
    return (
        continuous_accuracies[0],
        total_accuracies[0],
        float(np.max(continuous_accuracies)),
        float(np.max(total_accuracies)),
    )


class Metrics:
    """Per-piece metric computation, mirroring the reference Metrics class
    (beat_this/model/pl_module.py:320-339): val = F-measure + Cemgil; test
    additionally CMLt and AMLt. As in the reference, the logged "Cemgil"
    value is the mean of (cemgil_score, cemgil_max) — mir_eval returns the
    pair and the reference averages it implicitly via np.mean."""

    def __init__(self, eval_trim_beats: float) -> None:
        self.min_beat_time = eval_trim_beats

    def __call__(self, truth, preds, step: str) -> dict:
        truth = trim_beats(truth, min_beat_time=self.min_beat_time)
        preds = trim_beats(preds, min_beat_time=self.min_beat_time)
        if step == "val":
            return {
                "F-measure": f_measure(truth, preds),
                "Cemgil": float(np.mean(cemgil(truth, preds))),
            }
        elif step == "test":
            CMLc, CMLt, AMLc, AMLt = continuity(truth, preds)
            return {
                "F-measure": f_measure(truth, preds),
                "Cemgil": float(np.mean(cemgil(truth, preds))),
                "CMLt": CMLt,
                "AMLt": AMLt,
            }
        raise ValueError("step must be either val or test")
