"""Learning-rate schedule of the reference CosineWarmupScheduler
(beat_this/model/pl_module.py:342-369), counterpart of
beat_this_tpu/train/schedule.py: cosine annealing over
(1 - raise_last) * max_iters steps times a linear warmup, re-raising to
`raise_to` of the base rate for the final stretch when raise_last > 0."""

from __future__ import annotations

import math

import torch


def cosine_warmup_factor(step: int, warmup: int, max_iters: int, raise_last: float = 0.0,
                         raise_to: float = 0.5) -> float:
    """The factor on the base learning rate at optimizer step `step`. As in
    the reference, the warmup multiplies the cosine and includes step ==
    warmup, so the rate at step 0 is 0."""
    max_num_iters = int((1 - raise_last) * max_iters)
    if step >= max_num_iters:
        return raise_to * min((step - max_num_iters) / warmup, 1.0)
    factor = 0.5 * (1.0 + math.cos(math.pi * step / max_num_iters))
    if step <= warmup:
        factor *= step / warmup
    return factor


def cosine_warmup_scheduler(optimizer, warmup: int, max_iters: int,
                            last_step: int = -1) -> torch.optim.lr_scheduler.LambdaLR:
    """A LambdaLR stepped once per optimizer step; `last_step` >= 0 resumes
    after that many steps (the optimizer's groups then hold `initial_lr`)."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: cosine_warmup_factor(step, warmup, max_iters),
        last_epoch=last_step,
    )
