"""Bar-pointer DBN downbeat decoding: a batched Viterbi pass in torch, on the
given device.

Counterpart of beat_this_tpu/postprocessing/dbn.py, itself an equivalent of
madmom's `DBNDownBeatTrackingProcessor` for the parameters the reference
uses (beat_this/model/postprocessor.py:28-37):

  * Per bar length B in `beats_per_bar`, a bar state space of B beat cycles;
    each beat cycle spans the integer tempo intervals
    round(60*fps/max_bpm)..round(60*fps/min_bpm), with `interval` position
    states per interval.
  * Within a beat, states advance deterministically. At beat boundaries the
    tempo may change with probability exp(-lambda * |new/old - 1|), pruned
    below machine epsilon and row-normalized.
  * Observations: densities [no-beat, beat, downbeat] =
    [log((1-sum(act))/(lambda_obs-1)), log(act_beat), log(act_downbeat)]
    with lambda_obs=16; states in the first 1/16 of a beat emit "beat", of
    the first beat "downbeat".
  * One HMM per bar length, decoded independently from a uniform initial
    distribution with a transition step before the first observation; the
    pattern with the highest final log-probability wins.
  * Activations are trimmed where both columns are below the threshold
    (0.05), and with `correct=True` each decoded beat snaps to the frame
    with the largest single activation inside its beat region.

The state-space construction is the JAX package's numpy code, kept here as
the port's own copy. The forward pass runs all pieces at once, one frame per
step: for every state the best of at most K predecessors (a gather, an add,
a max and an argmax over K), in float32 as in the JAX package, so the two
give the same paths. Pieces shorter than the longest are padded with frames
that change nothing (choice STAY_CHOICE). Backtracking runs on the device
too, only for the pattern that won each piece. The JAX package's frame
buckets and power-of-two batch padding serve its compile cache and are not
carried over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# ---------------------------------------------------------------------------
# state space / transition / observation construction (host, numpy)
# ---------------------------------------------------------------------------


@dataclass
class PatternHmm:
    """Precomputed decode structure for one bar length."""

    num_beats: int
    num_states: int
    state_positions: np.ndarray  # (S,) float, 0..num_beats
    from_idx: np.ndarray  # (S, K) int32 predecessor state ids
    log_probs: np.ndarray  # (S, K) float32 log transition probs (-inf pad)
    pointers: np.ndarray  # (S,) int32 observation pointer (0/1/2)


def _beat_state_space(min_interval: float, max_interval: float):
    intervals = np.arange(np.round(min_interval), np.round(max_interval) + 1)
    intervals = intervals.astype(int)
    num_states = int(intervals.sum())
    first_states = np.cumsum(np.r_[0, intervals[:-1]]).astype(int)
    last_states = np.cumsum(intervals).astype(int) - 1
    positions = np.empty(num_states)
    state_intervals = np.empty(num_states, dtype=int)
    idx = 0
    for i in intervals:
        positions[idx : idx + i] = np.arange(i) / i
        state_intervals[idx : idx + i] = i
        idx += i
    return intervals, num_states, first_states, last_states, positions, state_intervals


def _exponential_transition(from_intervals, to_intervals, transition_lambda):
    ratio = to_intervals.astype(float) / from_intervals.astype(float)[:, None]
    prob = np.exp(-transition_lambda * np.abs(ratio - 1.0))
    prob[prob <= np.spacing(1)] = 0
    prob /= prob.sum(axis=1)[:, None]
    return prob


def build_pattern_hmm(
    num_beats: int,
    min_bpm: float,
    max_bpm: float,
    fps: float,
    transition_lambda: float,
    observation_lambda: float = 16.0,
) -> PatternHmm:
    min_interval = 60.0 * fps / max_bpm
    max_interval = 60.0 * fps / min_bpm
    (intervals, beat_states, first_b, last_b, pos_b, int_b) = _beat_state_space(
        min_interval, max_interval
    )
    # bar state space: replicate the beat space num_beats times
    num_states = beat_states * num_beats
    positions = np.concatenate([pos_b + n for n in range(num_beats)])
    state_intervals = np.tile(int_b, num_beats)
    first_states = [first_b + n * beat_states for n in range(num_beats)]
    last_states = [last_b + n * beat_states for n in range(num_beats)]

    # transitions: interior states advance deterministically from state-1
    is_first = np.zeros(num_states, dtype=bool)
    for f in first_states:
        is_first[f] = True
    # boundary transitions with tempo change
    trans_prob = _exponential_transition(
        state_intervals[last_states[0]], state_intervals[first_b], transition_lambda
    )  # from_prev_last x to_first, identical across beats
    max_preds = max(1, int((trans_prob > 0).sum(axis=0).max()))
    from_idx = np.zeros((num_states, max_preds), dtype=np.int32)
    log_probs = np.full((num_states, max_preds), -np.inf, dtype=np.float32)
    interior = ~is_first
    from_idx[interior, 0] = np.flatnonzero(interior) - 1
    log_probs[interior, 0] = 0.0
    for beat in range(num_beats):
        firsts = first_states[beat]
        lasts = last_states[beat - 1]  # beat-1 wraps to the last beat
        for j, state in enumerate(firsts):
            srcs = np.flatnonzero(trans_prob[:, j] > 0)
            from_idx[state, : len(srcs)] = lasts[srcs]
            log_probs[state, : len(srcs)] = np.log(trans_prob[srcs, j])

    # observation pointers
    pointers = np.zeros(num_states, dtype=np.int32)
    border = 1.0 / observation_lambda
    pointers[positions % 1 < border] = 1
    pointers[positions < border] = 2

    return PatternHmm(
        num_beats=num_beats,
        num_states=num_states,
        state_positions=positions,
        from_idx=from_idx,
        log_probs=log_probs,
        pointers=pointers,
    )


def threshold_activations(activations: np.ndarray, threshold: float):
    """Trim leading/trailing frames where all activations are below the
    threshold; returns (trimmed, first_index), madmom semantics."""
    first = last = 0
    idx = np.nonzero(activations >= threshold)[0]
    if idx.any():
        first = max(first, int(np.min(idx)))
        last = min(len(activations), int(np.max(idx)) + 1)
        return activations[first:last], first
    return activations[0:0], 0


# ---------------------------------------------------------------------------
# Viterbi (forward pass and backtracking, batched, on the device)
# ---------------------------------------------------------------------------

STAY_CHOICE = 127  # backtracking marker for padded (no-op) frames


@torch.no_grad()
def viterbi_forward(from_idx: torch.Tensor, log_probs: torch.Tensor, pointers: torch.Tensor,
                    log_densities: torch.Tensor, lengths: torch.Tensor):
    """The max-product forward pass over P pieces at once.

    from_idx (S, K) int64 predecessor ids, log_probs (S, K) float32,
    pointers (S,) int64; log_densities (P, T, 3) float32 [no-beat, beat,
    downbeat] per frame (frames past a piece's length arbitrary), lengths
    (P,) int64. Returns the final scores (P, S) float32 and the choices
    (T, P, S) int8: each state's best predecessor slot per frame, the first
    of equal candidates, STAY_CHOICE on the frames past a piece's length,
    which leave its scores unchanged."""
    pieces, frames, _ = log_densities.shape
    states = from_idx.shape[0]
    v = torch.full((pieces, states), -math.log(float(states)), dtype=torch.float32,
                   device=log_densities.device)
    choices = torch.empty((frames, pieces, states), dtype=torch.int8,
                          device=log_densities.device)
    stay = torch.tensor(STAY_CHOICE, dtype=torch.int8, device=log_densities.device)
    for t in range(frames):
        cand = v[:, from_idx] + log_probs  # (P, S, K)
        best_val, best = cand.max(dim=2)
        valid = (lengths > t)[:, None]
        v = torch.where(valid, best_val + log_densities[:, t][:, pointers], v)
        choices[t] = torch.where(valid, best.to(torch.int8), stay)
    return v, choices


@torch.no_grad()
def viterbi_backtrack(from_idx: torch.Tensor, choices: torch.Tensor,
                      starts: torch.Tensor) -> torch.Tensor:
    """choices (T, P, S) int8 and the final states `starts` (P,) int64 ->
    the state paths (T, P) int64. STAY_CHOICE frames keep the state."""
    frames, pieces, _ = choices.shape
    k = from_idx.shape[1]
    path = torch.empty((frames, pieces), dtype=torch.int64, device=choices.device)
    state = starts
    for t in range(frames - 1, -1, -1):
        path[t] = state
        c = choices[t].gather(1, state[:, None])[:, 0].to(torch.int64)
        prev = from_idx[state, c.clamp_max(k - 1)]
        state = torch.where(c == STAY_CHOICE, state, prev)
    return path


class DbnDecoder:
    """Equivalent of madmom's DBNDownBeatTrackingProcessor for the
    parameters the reference uses. Returns rows of [time_s, beat_number].
    The Viterbi passes run on `device`."""

    def __init__(
        self,
        beats_per_bar=(3, 4),
        min_bpm: float = 55.0,
        max_bpm: float = 215.0,
        fps: float = 50.0,
        transition_lambda: float = 100.0,
        observation_lambda: float = 16.0,
        threshold: float = 0.05,
        correct: bool = True,
        device="cpu",
    ):
        self.fps = float(fps)
        self.threshold = threshold
        self.correct = correct
        self.observation_lambda = observation_lambda
        self.device = torch.device(device)
        self.patterns = [
            build_pattern_hmm(
                b, min_bpm, max_bpm, fps, transition_lambda, observation_lambda
            )
            for b in beats_per_bar
        ]
        self._tensors = [
            (torch.from_numpy(hmm.from_idx.astype(np.int64)).to(self.device),
             torch.from_numpy(hmm.log_probs).to(self.device),
             torch.from_numpy(hmm.pointers.astype(np.int64)).to(self.device))
            for hmm in self.patterns
        ]

    def _log_densities(self, activations: np.ndarray) -> np.ndarray:
        dens = np.empty((len(activations), 3))
        dens[:, 0] = np.log(
            (1.0 - activations.sum(axis=1)) / (self.observation_lambda - 1)
        )
        dens[:, 1] = np.log(activations[:, 0])
        dens[:, 2] = np.log(activations[:, 1])
        return dens

    def decode_many(self, activations_list) -> list[np.ndarray]:
        """Decode several pieces with one batched forward pass per bar
        pattern, then one batched backtrack per pattern over the pieces it
        won."""
        items = []
        for activations in activations_list:
            activations = np.asarray(activations, dtype=np.float64)
            first = 0
            if self.threshold:
                activations, first = threshold_activations(activations, self.threshold)
            items.append((activations, first))
        outputs: list = [None] * len(items)
        idxs = []
        for i, (act, _) in enumerate(items):
            if not act.any():
                outputs[i] = np.empty((0, 2))
            else:
                idxs.append(i)
        if idxs:
            frames = max(len(items[i][0]) for i in idxs)
            dens = np.zeros((len(idxs), frames, 3), dtype=np.float32)
            for row, i in enumerate(idxs):
                act = items[i][0]
                dens[row, : len(act)] = self._log_densities(act)
            dens_dev = torch.from_numpy(dens).to(self.device)
            lengths = torch.tensor([len(items[i][0]) for i in idxs], device=self.device)
            per_pattern = [viterbi_forward(*tensors, dens_dev, lengths)
                           for tensors in self._tensors]
            best_logps, best_states = zip(*(final.max(dim=1) for final, _ in per_pattern))
            best_logps = torch.stack(best_logps)  # (patterns, rows)
            winner = best_logps.argmax(dim=0).cpu().numpy()
            paths = {}
            for pat, ((from_idx, _, _), (_, choices)) in enumerate(
                    zip(self._tensors, per_pattern)):
                rows = np.flatnonzero(winner == pat)
                if rows.size == 0:
                    continue
                sel = torch.from_numpy(rows).to(self.device)
                got = viterbi_backtrack(from_idx, choices[:, sel], best_states[pat][sel])
                got = got.cpu().numpy()
                for col, row in enumerate(rows):
                    paths[row] = got[:, col]
            for row, i in enumerate(idxs):
                act, first = items[i]
                outputs[i] = self._path_to_beats(
                    self.patterns[winner[row]], paths[row][: len(act)], act, first)
        return outputs

    def __call__(self, activations: np.ndarray) -> np.ndarray:
        """activations: (T, 2) [beat-only, downbeat] probabilities."""
        return self.decode_many([activations])[0]

    def _path_to_beats(self, hmm: PatternHmm, path: np.ndarray,
                       activations: np.ndarray, first: int) -> np.ndarray:
        positions = hmm.state_positions[path]
        beat_numbers = positions.astype(int) + 1
        if self.correct:
            beats = []
            beat_range = hmm.pointers[path] >= 1
            idx = np.nonzero(np.diff(beat_range.astype(int)))[0] + 1
            if beat_range.size and beat_range[0]:
                idx = np.r_[0, idx]
            if beat_range.size and beat_range[-1]:
                idx = np.r_[idx, len(beat_range)]
            if idx.any():
                for left, right in idx.reshape((-1, 2)):
                    # frame with the highest single activation value
                    peak = int(np.argmax(activations[left:right]) // 2) + left
                    beats.append(peak)
            beats = np.asarray(beats, dtype=int)
        else:
            beats = np.nonzero(np.diff(beat_numbers))[0] + 1
        if beats.size == 0:
            return np.empty((0, 2))
        return np.vstack(
            ((beats + first) / self.fps, beat_numbers[beats])
        ).T
