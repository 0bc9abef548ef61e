"""Training losses, counterpart of beat_this_tpu/train/loss.py (reference
beat_this/model/loss.py): masked weighted BCE and the shift-tolerant
variants, where predictions are max-pooled with stride 1 over +/- tolerance
frames (VALID: the output shrinks by 2 * tolerance) so a positive label
rewards the strongest nearby prediction.

BCE-with-logits is the mean over all elements of
weight * (pos_weight * t * softplus(-x) + (1 - t) * softplus(x)); the weight
does not renormalize the mean. Frames within 2 * tolerance of a positive
target, except the positives, get weight 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(preds, targets, weight=None, pos_weight: float = 1.0) -> torch.Tensor:
    """Mean-reduced BCE with logits in float32, as
    `F.binary_cross_entropy_with_logits(weight=..., pos_weight=...)`."""
    preds, targets = preds.float(), targets.float()
    loss = -(pos_weight * targets * F.logsigmoid(preds)
             + (1.0 - targets) * F.logsigmoid(-preds))
    if weight is not None:
        loss = loss * weight.float()
    return loss.mean()


def max_pool_valid(x: torch.Tensor, window: int) -> torch.Tensor:
    """Max over windows of `window` frames along the last axis, stride 1, no
    padding (the output is window - 1 frames shorter)."""
    shape = x.shape
    pooled = F.max_pool1d(x.reshape(-1, 1, shape[-1]), window, stride=1, padding=0)
    return pooled.reshape(shape[:-1] + (pooled.shape[-1],))


class MaskedBCELoss:
    """Reference MaskedBCELoss (loss.py:9-35)."""

    def __init__(self, pos_weight: float = 1.0):
        self.pos_weight = float(pos_weight)

    def __call__(self, preds, targets, mask=None):
        return bce_with_logits(preds, targets, mask, self.pos_weight)


class ShiftTolerantBCELoss:
    """Reference ShiftTolerantBCELoss (loss.py:38-92)."""

    def __init__(self, pos_weight: float = 1.0, tolerance: int = 3):
        self.pos_weight = float(pos_weight)
        self.tolerance = int(tolerance)

    def spread(self, x, factor: int = 1):
        if self.tolerance == 0:
            return x
        return max_pool_valid(x, 1 + 2 * factor * self.tolerance)

    def crop(self, x, factor: int = 1):
        c = factor * self.tolerance
        return x[..., c : x.shape[-1] - c]

    def __call__(self, preds, targets, mask=None):
        targets = targets.float()
        spread_preds = self.crop(self.spread(preds.float()))
        cropped_targets = self.crop(targets, factor=2)
        look_at = cropped_targets + (1.0 - self.spread(targets, factor=2))
        if mask is not None:
            look_at = look_at * self.crop(mask.float(), factor=2)
        return bce_with_logits(spread_preds, cropped_targets, look_at, self.pos_weight)


class SplittedShiftTolerantBCELoss:
    """Reference SplittedShiftTolerantBCELoss (loss.py:95-160): separate
    positive and negative terms; equal to ShiftTolerantBCELoss on binary
    targets."""

    def __init__(self, pos_weight: float = 1.0, tolerance: int = 3):
        self.pos_weight = float(pos_weight)
        self.spread_preds = int(tolerance)
        self.spread_targets = 2 * int(tolerance)

    @staticmethod
    def _spread(x, amount):
        return max_pool_valid(x, 1 + 2 * amount) if amount else x

    @staticmethod
    def _crop(x, desired_length):
        amount = (x.shape[-1] - desired_length) // 2
        if amount < 0:
            raise ValueError("Desired length must be smaller than input length")
        return x[..., amount : x.shape[-1] - amount] if amount else x

    def __call__(self, preds, targets, mask):
        preds, targets, mask = preds.float(), targets.float(), mask.float()
        output_length = targets.shape[-1] - 2 * self.spread_targets
        cropped_preds = self._crop(self._spread(preds, self.spread_preds), output_length)
        cropped_targets = self._crop(targets, output_length)
        cropped_mask = self._crop(mask, output_length)
        loss_positive = bce_with_logits(cropped_preds, cropped_targets,
                                        cropped_targets * cropped_mask, self.pos_weight)
        cropped_spread = self._crop(self._spread(targets, self.spread_targets), output_length)
        loss_negative = bce_with_logits(cropped_preds, cropped_spread,
                                        (1.0 - cropped_spread) * cropped_mask, self.pos_weight)
        return loss_positive + loss_negative


LOSSES = {
    "shift_tolerant_weighted_bce": ShiftTolerantBCELoss,
    "splitted_shift_tolerant_weighted_bce": SplittedShiftTolerantBCELoss,
    "weighted_bce": MaskedBCELoss,
    "bce": MaskedBCELoss,
}


def make_losses(loss_type: str, pos_weights: dict):
    """(beat_loss, downbeat_loss) by the reference's selection
    (beat_this/model/pl_module.py:64-91); "bce" ignores pos_weights."""
    if loss_type not in LOSSES:
        raise ValueError(f"loss_type must be one of {sorted(LOSSES)}, got {loss_type!r}")
    cls = LOSSES[loss_type]
    if loss_type == "bce":
        return cls(), cls()
    return cls(pos_weight=pos_weights["beat"]), cls(pos_weight=pos_weights["downbeat"])
