"""Cross-cutting helpers: framewise targets, beat numbering, TSV output.

Behavioural equivalents of the reference utilities
(reference: beat_this/utils.py:7-102), reimplemented — beat numbering is
vectorized (searchsorted + per-measure cumulative counts) instead of the
reference's per-beat Python loop.

The port's copy of beat_this_tpu/utils.py, kept so that the port imports nothing of
the JAX package; the tests hold the two to identical results.
"""

from __future__ import annotations

import re
import warnings
from pathlib import Path

import numpy as np

_AUG_SUFFIX = re.compile(r"^(ps|ts)(-?\d+)$")
_AUG_NAMES = {"ps": "shift", "ts": "stretch"}


def index_to_framewise(index, length: int) -> np.ndarray:
    """One-hot boolean sequence from frame indices
    (reference: beat_this/utils.py:7-11)."""
    sequence = np.zeros(length, dtype=bool)
    sequence[index] = True
    return sequence


def filename_to_augmentation(filename) -> dict:
    """Parse `_psN` / `_tsN` stem suffixes into {"shift": N} / {"stretch": N}
    (reference: beat_this/utils.py:14-23)."""
    augmentations: dict[str, int] = {}
    for part in Path(filename).stem.split("_")[1:]:
        m = _AUG_SUFFIX.match(part)
        if m:
            augmentations[_AUG_NAMES[m.group(1)]] = int(m.group(2))
    return augmentations


def infer_beat_numbers(beats: np.ndarray, downbeats: np.ndarray) -> np.ndarray:
    """Number each beat within its measure, with 1 at every downbeat.

    Vectorized equivalent of the reference's sequential counter
    (reference: beat_this/utils.py:26-76): each beat's number is its offset
    from the preceding downbeat plus one; beats before the first downbeat
    (a pickup measure) are numbered as if they ended a measure of the same
    length as the first full measure, falling back to counting from 2 when
    that length cannot be estimated. Beats after the last downbeat keep
    counting upward. Every downbeat must also appear in `beats`.
    """
    beats = np.asarray(beats)
    downbeats = np.asarray(downbeats)
    if not np.all(np.isin(downbeats, beats)):
        raise ValueError("Not all downbeats are beats.")

    # measure[i]: how many downbeats lie at or before beat i (0 = pickup)
    measure = np.searchsorted(downbeats, beats, side="right")
    # index into `beats` of each downbeat (exact membership checked above)
    downbeat_idx = np.searchsorted(beats, downbeats)
    # offset of each beat from the start of its measure (pickup starts at 0)
    measure_start = np.concatenate(([0], downbeat_idx))[measure]
    numbers = np.arange(len(beats)) - measure_start + 1

    # pickup handling: shift the pre-downbeat counts so the last pickup beat
    # lands on the first full measure's length
    pickup_shift = 1
    if len(downbeats) >= 2:
        first_measure_len = downbeat_idx[1] - downbeat_idx[0]
        n_pickup = downbeat_idx[0]
        if n_pickup < first_measure_len:
            pickup_shift = first_measure_len - n_pickup
        else:
            warnings.warn(
                "pickup measure is longer than the first full measure; "
                "numbering its beats from 2 instead of estimating its length"
            )
    else:
        warnings.warn(
            "fewer than two downbeats detected; numbering any pickup beats "
            "from 2 instead of estimating the pickup measure's length"
        )
    numbers[measure == 0] += pickup_shift
    return numbers


def save_beat_tsv(beats: np.ndarray, downbeats: np.ndarray, outpath) -> None:
    """Write the standard `.beats` TSV, one `time<TAB>beat_number` row per
    beat (reference: beat_this/utils.py:79-102). The file is staged next to
    its destination and renamed into place, so an interrupted run never
    leaves a truncated output behind."""
    numbers = infer_beat_numbers(beats, downbeats)
    outpath = Path(outpath)
    outpath.parent.mkdir(parents=True, exist_ok=True)
    rows = "".join(f"{time}\t{number}\n" for time, number in zip(beats, numbers))
    staging = outpath.with_name(outpath.name + ".part")
    try:
        staging.write_text(rows)
        staging.replace(outpath)
    finally:
        staging.unlink(missing_ok=True)


def replace_state_dict_key(state_dict: dict, old: str, new: str) -> dict:
    """Rewrite `old` -> `new` inside every key, in place (matching the
    reference helper's mutate-and-return contract, beat_this/utils.py:105-111).
    """
    for key in [k for k in state_dict if old in k]:
        state_dict[key.replace(old, new)] = state_dict.pop(key)
    return state_dict
