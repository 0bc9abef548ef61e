"""The model's weights, made on the device from the seed in one draw, with
the reference checkpoint's initial distributions
(beat_this/model/beat_tracker.py:170-186): linear weights N(0, 0.02),
convolutions N(0, 2 / (out * k_time * k_freq)), biases 0, norm gains and
batch-norm scales 1.

For serving, a trained checkpoint's traits that the work depends on are set
from the inputs: the input batch norm takes the statistics of the corpus's
log-mel (with identity statistics the log-mel offset swamps the network),
and the head is fitted by ridge least squares, on the reference's features,
to targets that peak at the synthetic beats (with a random head the logits
are noise-like, and the postprocessor would find a peak every few frames)."""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.model import Reference, param_shapes


def make_state(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    shapes = param_shapes(cfg)
    drawn = [k for k, s in shapes.items() if len(s) >= 2]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(shapes[k]) for k in drawn), generator=gen, device=device)
    state, at = {}, 0
    for name, shape in shapes.items():
        if name in drawn:
            n = math.prod(shape)
            std = 0.02 if len(shape) == 2 else math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            state[name] = (flat[at : at + n] * std).reshape(shape)
            at += n
        elif name.endswith(("gamma", ".weight", "running_var")):
            state[name] = torch.ones(shape, device=device)
        else:
            state[name] = torch.zeros(shape, device=device)
    return state


def set_input_stats(state: dict, mels: list[torch.Tensor]) -> None:
    mel = torch.cat(mels)
    state["frontend.stem.bn1d.running_mean"] = mel.mean(0)
    state["frontend.stem.bn1d.running_var"] = mel.var(0)


def fit_head(cfg: dict, state: dict, windows: list[tuple[torch.Tensor, np.ndarray]]) -> None:
    """Set the head of `state` from a ridge fit, on the reference's features
    of `windows` (log-mel (frames, 128), beat frames), of targets +1 at the
    beats, falling off over a frame, -1 elsewhere, positives and negatives
    weighing half each. The downbeat output is the beat output less the
    75th percentile of its fitted value at the beats: every downbeat peak is
    then a beat peak, as in music (a piece with a downbeat and no beat is
    refused by `.beats` numbering), about one beat in four."""
    model = Reference(cfg, state)
    xs, ys = [], []
    with torch.no_grad():
        for mel, beat in windows:
            h = model.features(mel[None])[0].double()
            xs.append(torch.cat([h, torch.ones_like(h[:, :1])], 1))
            pos = np.arange(len(mel))
            d = np.abs(pos[:, None] - beat[None, :]).min(1) if len(beat) else np.full(len(mel), 9)
            ys.append(torch.from_numpy(-1.0 + 2.0 * np.exp(-0.5 * d.astype(np.float64) ** 2)))
    x, y = torch.cat(xs), torch.cat(ys).to(xs[0].device)
    positive = y > 0
    w = torch.where(positive, 0.5 / positive.sum(), 0.5 / (~positive).sum())
    gram = (x * w[:, None]).T @ x
    gram.diagonal()[:-1] += 1e-3 * gram.diagonal()[:-1].mean()  # ridge, bias unpenalized
    coef = torch.linalg.solve(gram, (x * w[:, None]).T @ y)
    fitted = x @ coef
    margin = max(float(torch.quantile(fitted[y > 0.99], 0.75)), 0.1)
    weight = torch.zeros((2, coef.numel() - 1), dtype=torch.float32, device=coef.device)
    bias = torch.zeros(2, dtype=torch.float32, device=coef.device)
    if cfg["sum_head"]:  # beat = out0 + out1, downbeat = out1
        weight[1], bias[0], bias[1] = coef[:-1].float(), margin, float(coef[-1]) - margin
    else:
        weight[0] = weight[1] = coef[:-1].float()
        bias[0], bias[1] = float(coef[-1]), float(coef[-1]) - margin
    state["task_heads.beat_downbeat_lin.weight"] = weight
    state["task_heads.beat_downbeat_lin.bias"] = bias
