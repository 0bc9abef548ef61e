"""The precision of the reference's products.

`Quant(kind)` rounds both operands of every product (matrix products,
convolutions, the attention's score and value products) before it runs in
float32 with TF32 off:
  * "float32": unchanged, the reference itself;
  * "tf32": the mantissa rounded to 10 bits (round to nearest), what a
    TF32 tensor-core product reads: the control of a float32 cell;
  * "fp8": float8 e4m3 with one scale per tensor (amax to 448), the
    control of a bfloat16 cell.
"""

from __future__ import annotations

import torch

KINDS = ("float32", "tf32", "fp8")
E4M3_MAX = 448.0


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 `t` with its mantissa rounded to TF32's 10 bits."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """float32 `t` through float8 e4m3 under one scale for the tensor."""
    t = t.float()
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Round(torch.autograd.Function):
    """Rounded forward; the gradient passes straight through, so the
    control's backward runs its products on rounded operands too."""

    @staticmethod
    def forward(ctx, t, fn):
        return fn(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Quant:
    def __init__(self, kind: str = "float32"):
        if kind not in KINDS:
            raise ValueError(f"precision must be one of {KINDS}, got {kind!r}")
        self.kind = kind
        self.fn = {"tf32": tf32_round, "fp8": fp8_round}.get(kind)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.fn is None:
            return t
        return _Round.apply(t, self.fn)
