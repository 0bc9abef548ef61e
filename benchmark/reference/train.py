"""The reference's training step (beat_this/model/pl_module.py, loss.py):
the shift-tolerant weighted BCE of beats and downbeats, gradients averaged
over the microbatches, AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight
decay on parameters of two or more dimensions) and the cosine warmup
schedule (pl_module.py:342-369), whose rate at step 0 is 0."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .model import Reference, seed_stream

TOLERANCE = 3
BETAS, EPS = (0.9, 0.999), 1e-8


def _pool(x, window):
    return F.max_pool1d(x.reshape(-1, 1, x.shape[-1]), window, stride=1).reshape(
        x.shape[:-1] + (-1,))


def shift_tolerant_bce(preds, targets, mask, pos_weight):
    """Predictions max-pooled over +/- 3 frames, both cropped by 6; frames
    within 6 of a positive target, except the positives, weigh 0."""
    tol = TOLERANCE
    spread = _pool(preds, 1 + 2 * tol)[..., tol:-tol]
    crop_t = targets[..., 2 * tol:-2 * tol]
    look = crop_t + (1.0 - _pool(targets, 1 + 4 * tol))
    look = look * mask[..., 2 * tol:-2 * tol]
    loss = -(pos_weight * crop_t * F.logsigmoid(spread) + (1.0 - crop_t) * F.logsigmoid(-spread))
    return (loss * look).mean()


def lr_factor(step: int, warmup: int, max_steps: int) -> float:
    factor = 0.5 * (1.0 + math.cos(math.pi * step / max_steps))
    return factor * step / warmup if step <= warmup else factor


class Step:
    """Steps of the reference model's parameters `params` (float32 leaves
    that require grad, by checkpoint name)."""

    def __init__(self, cfg: dict, params: dict, train: dict, quant=None):
        self.cfg, self.params, self.train = cfg, params, train
        self.model = Reference(cfg, params, quant)
        self.m = {k: torch.zeros_like(v) for k, v in params.items() if v.requires_grad}
        self.v = {k: torch.zeros_like(v) for k, v in self.m.items()}
        self.t = 0

    def grads(self, micro_batches, micro_seeds) -> tuple[float, dict]:
        """Mean loss and averaged gradients over the microbatches."""
        leaves = {k: self.params[k] for k in self.m}
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        tr, total = self.train, 0.0
        for batch, seed in zip(micro_batches, micro_seeds):
            beat, down = self.model.forward(batch["spect"], train=True, seeds=seed_stream(seed))
            mask = batch["padding_mask"].float()
            loss = (shift_tolerant_bce(beat, batch["truth_beat"], mask, tr["pos_weight_beat"])
                    + shift_tolerant_bce(down, batch["truth_downbeat"],
                                         mask * batch["downbeat_mask"].float()[:, None],
                                         tr["pos_weight_downbeat"]))
            parts = torch.autograd.grad(loss / len(micro_batches), list(leaves.values()))
            for k, g in zip(leaves, parts):
                grads[k] += g
            total += float(loss.detach()) / len(micro_batches)
        return total, grads

    def update(self, grads: dict) -> None:
        """One AdamW step at the schedule's rate for step `self.t`."""
        tr = self.train
        lr = tr["lr"] * lr_factor(self.t, tr["warmup_steps"], tr["max_steps"])
        self.t += 1
        b1, b2 = BETAS
        with torch.no_grad():
            for k, g in grads.items():
                p = self.params[k]
                if p.ndim >= 2:
                    p.mul_(1.0 - lr * tr["weight_decay"])
                self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                m_hat = self.m[k] / (1.0 - b1**self.t)
                v_hat = self.v[k] / (1.0 - b2**self.t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + EPS))
