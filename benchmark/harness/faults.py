"""Faults planted in the timed path, which the comparison has to catch
(`run(..., patch=...)`); each takes the cell after it is built and before
its first compared work (a training cell's first steps, a library cell's
warm-up and window).

Library cells:
  * "logit": an answer altered where it is produced: one logit of every
    forward's first row raised by 1;
  * "beats": an answer altered where it is written: each file's last beat
    that is not a downbeat left out of its `.beats` file;
  * "half": half of each forward's rows left out, their logits copied from
    the other half.
Training cells:
  * "unchanged": the optimizer step returns the state unchanged;
  * "half": half of each microbatch's crops left out, the loss's mean
    taken over the rest.
"""

from __future__ import annotations

import numpy as np

LIBRARY = ("logit", "beats", "half")
TRAIN = ("unchanged", "half")


def plant(cell, fault: str) -> None:
    if cell.work_name == "audio_s":
        _library(cell, fault)
    else:
        _train(cell, fault)


def _library(cell, fault: str) -> None:
    pred = cell.f2f.predictor
    forward = pred._forward
    if fault == "logit":
        def raised(batch, valid_lengths=None):
            beat, down = forward(batch, valid_lengths)
            beat = beat.copy()
            beat[0, beat.shape[1] // 2] += 1.0
            return beat, down
        pred._forward = raised
    elif fault == "half":
        def halved(batch, valid_lengths=None):
            n = len(batch)
            keep = (n + 1) // 2
            v = None if valid_lengths is None else valid_lengths[:keep]
            beat, down = forward(batch[:keep], v)
            idx = [i % keep for i in range(n)]
            return beat[idx], down[idx]
        pred._forward = halved
    elif fault == "beats":
        post = cell.f2f.frames2beats

        def dropped(*args):
            beats, downs = post(*args)
            out = []
            for b, d in zip(beats, downs):
                keep = ~np.isin(b, d)  # a downbeat must stay a beat
                if keep.any():
                    b = np.delete(b, np.flatnonzero(keep)[-1])
                out.append(b)
            return tuple(out), downs
        cell.f2f.frames2beats = dropped
    else:
        raise ValueError(f"no library fault {fault!r}")


def _train(cell, fault: str) -> None:
    if fault == "unchanged":
        cell.opt.step = lambda *a, **k: None
    elif fault == "half":
        step = cell.train_step

        def halved(model, opt, sched, batch, gen, tc, **kw):
            keep = {k: v[:, : max(1, v.shape[1] // 2)] for k, v in batch.items()}
            return step(model, opt, sched, keep, gen, tc, **kw)
        cell.train_step = halved
    else:
        raise ValueError(f"no training fault {fault!r}")
