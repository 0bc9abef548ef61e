"""Fused feed-forward residual `x + W2 gelu(W1 rmsnorm(x) + b1) + b2`.

Counterpart of beat_this_tpu/ops/fused_ff.py:fused_ff. On a CUDA tensor
`fused_ff` launches the hand-written kernels of `csrc/fused_ff.cu` (the
training forward's launches at dropout rate 0, every product on the tensor
cores; the library lays out the scratch and gives its size); on a CPU
tensor it runs the plain version `fused_ff_ref`, the composable path.

`fused_ff_train` is the training twin (fused_ff.py:fused_ff_train): dropout
after the GELU and after W2 from a Philox seed (`ops/dropout.py`, the rows
counted from the global batch's `item0`), and a backward that recomputes the
block from x (`csrc/fused_ff_train.cu`), so only the inputs are saved
between the passes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from beat_this_tpu_torch.model.layers import (
    FeedForward,
    feed_forward,
    rms_norm,
    round_grad,
    round_value,
    rows_mask,
    wide,
)
from beat_this_tpu_torch.ops import _build
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.profiler import op_entry

SUPPORTED_DIMS = (32, 64, 128, 256, 384, 512)


def dtype_code(dtype: torch.dtype) -> int:
    """The C entry points' dtype argument: 0 float32, 1 bfloat16."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise ValueError(f"the kernels take float32 or bfloat16, got {dtype}")


def kernel_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight as the kernels read it: contiguous, in the compute dtype."""
    return w.detach().to(dtype).contiguous()


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def ff_params(ff: FeedForward, dtype: torch.dtype) -> list[torch.Tensor]:
    """The feed-forward's parameters as the C entry points take them, in
    their order (gamma, w1, b1, w2, b2): weights in `dtype` (the training
    kernels' compute dtype; float32 for the eval kernel, which rounds them
    itself), the norm gain and biases in float32, as the TPU kernels hold
    them."""
    norm, lin1, _, _, lin2, _ = ff.net
    return [f32(norm.gamma), kernel_weight(lin1.weight, dtype), f32(lin1.bias),
            kernel_weight(lin2.weight, dtype), f32(lin2.bias)]


@functools.lru_cache(maxsize=256)
def eval_scratch(name: str, code: int, c: int, rows: int, m: int) -> int:
    """Bytes of an eval kernel's scratch by shape, as the library lays it out
    (`name`: bt_fused_ff_scratch or bt_fused_time_scratch)."""
    nbytes = ctypes.c_longlong()
    _build.check(getattr(_build.load_library(), name)(code, c, rows, m, ctypes.byref(nbytes)),
                 name)
    return nbytes.value


def fused_ff_ref(x: torch.Tensor, ff: FeedForward) -> torch.Tensor:
    """Plain PyTorch version: `x + feed_forward(ff, x)`."""
    return x + feed_forward(ff, x)


def _check_cuda(name: str, x: torch.Tensor, c: int) -> int:
    """Raise unless `x` is a CUDA tensor with C in SUPPORTED_DIMS; returns
    the dtype code."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {x.device}")
    if c not in SUPPORTED_DIMS:
        raise ValueError(f"{name} kernel supports C in {SUPPORTED_DIMS}, got {c}")
    return dtype_code(x.dtype)


@op_entry
def fused_ff(x: torch.Tensor, ff: FeedForward) -> torch.Tensor:
    """x: (..., C) -> x + FF(x). CUDA tensors run the fused kernel (C in
    SUPPORTED_DIMS, float32 or bfloat16); CPU tensors the plain version."""
    if x.device.type == "cpu":
        return fused_ff_ref(x, ff)
    c = x.shape[-1]
    code = _check_cuda("fused_ff", x, c)
    lib = _build.load_library()
    xc = x.contiguous()
    rows, m = xc.numel() // c, ff.net[1].out_features
    out = torch.empty_like(xc)
    params = ff_params(ff, torch.float32)  # the kernel rounds the weights itself
    nbytes = eval_scratch("bt_fused_ff_scratch", code, c, rows, m)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        _build.check(
            lib.bt_fused_ff(
                code, c, xc.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(),
                scratch.data_ptr(), nbytes, rows, m, stream_of(x),
            ),
            "bt_fused_ff",
        )
    fused_ff.launches += 1
    return out


fused_ff.launches = 0


CARD_SMS = 132  # streaming multiprocessors of the H100 SXM


FF_MIN_GROUP_ROWS = 256  # the fewest rows a group of B9's weight-gradient products takes


def ff_wgrad_split(rows: int, tiles: int) -> int:
    """Rows per group of B9's weight-gradient products dW1 = d_pre1^T g and
    dW2 = d_y^T h1d over `rows` rows, from the shape alone. The kernel cuts
    the rows into ceil(rows / group rows) groups of `tiles` blocks each (the
    output tiles of one product, `ff_bwd_plan`): enough groups for about two
    blocks per SM (C 512: 64 tiles x 5 groups; C 32: 1 tile x 264 groups
    over 384000 rows), each of at least FF_MIN_GROUP_ROWS rows. Each group
    adds one float32 partial of each weight gradient to the scratch, summed
    in a fixed order, so a given shape gives the same bits on every run."""
    target = -(-2 * CARD_SMS // tiles)
    return max(FF_MIN_GROUP_ROWS, -(-rows // target))


def ff_bwd_plan(rows: int, c: int, m: int, dtype: torch.dtype) -> tuple[int, int]:
    """(rows per weight-gradient group, scratch bytes) of B9 over `rows`
    rows of width `c`, hidden width `m`, in `dtype`; the kernel library
    gives the tile count and lays out the scratch (csrc/fused_ff_train.cu:
    bt_ff_wgrad_tiles, bt_ff_train_bwd_scratch)."""
    lib = _build.load_library()
    code = dtype_code(dtype)
    tiles, nbytes = ctypes.c_int(), ctypes.c_longlong()
    _build.check(lib.bt_ff_wgrad_tiles(c, m, ctypes.byref(tiles)), "bt_ff_wgrad_tiles")
    group_rows = ff_wgrad_split(rows, tiles.value)
    _build.check(lib.bt_ff_train_bwd_scratch(code, c, rows, m, group_rows, ctypes.byref(nbytes)),
                 "bt_ff_train_bwd_scratch")
    return group_rows, nbytes.value


def ff_train_branch(x32: torch.Tensor, ff: FeedForward, dtype: torch.dtype,
                    dropout_rate: float, seed: Optional[int], salt: int,
                    row0: int = 0) -> torch.Tensor:
    """The dropped feed-forward branch on the float32 (or float64) rows
    `x32`, with the rounding points of the compute dtype `dtype`: g, the
    weights and the dropped hidden layer rounded before their products, the
    cotangents of both products rounded before theirs. Masks from `seed`
    under `salt` (off when `seed` is None), the rows counted from `row0`."""
    norm, lin1, _, _, lin2, _ = ff.net
    acc = x32.dtype
    g = round_value(rms_norm(x32, norm.gamma), dtype)
    w1 = round_value(lin1.weight.to(acc), dtype)
    w2 = round_value(lin2.weight.to(acc), dtype)
    h = F.gelu(round_grad(F.linear(g, w1), dtype) + lin1.bias.to(acc))
    on = dropout_rate > 0.0 and seed is not None
    if on:
        with torch.no_grad():
            keep = rows_mask(seed, salt, drop.SITE_FF_HIDDEN, h, dropout_rate, row0)
        h = h * keep
    y = round_grad(F.linear(round_value(h, dtype), w2), dtype) + lin2.bias.to(acc)
    if on:
        with torch.no_grad():
            keep = rows_mask(seed, salt, drop.SITE_FF_OUT, y, dropout_rate, row0)
        y = y * keep
    return y


def first_row(x: torch.Tensor, item0: int) -> int:
    """The global index of the first row of `x` viewed as (rows, C) when
    its first item (leading axis) is the global batch's item `item0`."""
    return item0 * (x[0].numel() // x.shape[-1])


def fused_ff_train_ref(x: torch.Tensor, ff: FeedForward, dropout_rate: float = 0.0,
                       seed: Optional[int] = None, item0: int = 0) -> torch.Tensor:
    """Plain PyTorch version: `x + feed_forward(ff, x)` with dropout, in
    float32 with the kernel's bfloat16 rounding points (`ff_train_branch`),
    the residual sum rounded once."""
    x32 = wide(x)
    branch = ff_train_branch(x32, ff, x.dtype, dropout_rate, seed, drop.SALT_FF,
                             first_row(x, item0))
    return (x32 + branch).to(x.dtype)


@op_entry
def ff_train_fwd(x, gamma, w1, b1, w2, b2, dropout_rate, seed, row0: int = 0) -> torch.Tensor:
    """Launch the training forward on x (rows, C): x + dropout(FF(x)). The
    library lays out its scratch (the operands g, W1^T, W2^T and the dropped
    hidden layer; csrc/ff_train.cuh) and gives its size."""
    rows, c = x.shape
    m = w1.shape[0]
    code = _check_cuda("fused_ff_train", x, c)
    lib = _build.load_library()
    nbytes = ctypes.c_longlong()
    _build.check(lib.bt_ff_train_fwd_scratch(code, c, rows, m, ctypes.byref(nbytes)),
                 "bt_ff_train_fwd_scratch")
    params = [f32(gamma), kernel_weight(w1, x.dtype), f32(b1), kernel_weight(w2, x.dtype), f32(b2)]
    out = torch.empty_like(x)
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        _build.check(
            lib.bt_ff_train_fwd(
                code, c, x.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(),
                scratch.data_ptr(), nbytes.value, rows, m,
                *drop.kernel_args(dropout_rate, seed, drop.SALT_FF), *drop.base_args(0, row0),
                stream_of(x),
            ),
            "bt_ff_train_fwd",
        )
    ff_train_fwd.launches += 1
    return out


@op_entry
def ff_train_bwd(x, gamma, w1, b1, w2, dout, dropout_rate, seed, dtype=None, row0: int = 0):
    """Launch the training backward; returns (dx, dgamma, dw1, db1, dw2, db2),
    dx in the dtype of x, the parameter gradients in float32 and torch's
    layouts. `dtype`: the compute dtype of the weights, dout and the rounding
    points, x's by default; float32 x with bfloat16 compute is what the
    frequency block's backward runs on its residual. `row0`: the global
    index of x's first row."""
    rows, c = x.shape
    m = w1.shape[0]
    dtype = x.dtype if dtype is None else dtype
    xcode = _check_cuda("fused_ff_train", x, c)
    code = dtype_code(dtype)
    lib = _build.load_library()
    group_rows, nbytes = ff_bwd_plan(rows, c, m, dtype)
    dev = x.device
    params = [f32(gamma), kernel_weight(w1, dtype), f32(b1), kernel_weight(w2, dtype)]
    dout = dout.to(dtype).contiguous()
    dx = torch.empty_like(x)
    grads = [torch.empty(shape, dtype=torch.float32, device=dev)
             for shape in ((c,), (m, c), (m,), (c, m), (c,))]
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _build.check(
            lib.bt_ff_train_bwd(
                code, xcode, c, x.data_ptr(), *(p.data_ptr() for p in params), dout.data_ptr(),
                dx.data_ptr(), *(g.data_ptr() for g in grads), scratch.data_ptr(), nbytes,
                rows, m, group_rows, *drop.kernel_args(dropout_rate, seed, drop.SALT_FF),
                *drop.base_args(0, row0), stream_of(x),
            ),
            "bt_ff_train_bwd",
        )
    ff_train_bwd.launches += 1
    return (dx, *grads)


ff_train_fwd.launches = 0
ff_train_bwd.launches = 0


class _FusedFFTrain(torch.autograd.Function):
    """x (rows, C) and the FF parameters -> x + dropout(FF(x)); the backward
    regenerates the masks from `seed`."""

    @staticmethod
    def forward(ctx, x, gamma, w1, b1, w2, b2, dropout_rate, seed, row0):
        ctx.save_for_backward(x, gamma, w1, b1, w2)
        ctx.dropout_rate, ctx.seed, ctx.row0, ctx.b2_dtype = dropout_rate, seed, row0, b2.dtype
        return ff_train_fwd(x, gamma, w1, b1, w2, b2, dropout_rate, seed, row0)

    @staticmethod
    def backward(ctx, dout):
        x, gamma, w1, b1, w2 = ctx.saved_tensors
        dx, dgamma, dw1, db1, dw2, db2 = ff_train_bwd(
            x, gamma, w1, b1, w2, dout, ctx.dropout_rate, ctx.seed, row0=ctx.row0)
        return (dx, dgamma.to(gamma.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(ctx.b2_dtype), None, None, None)


def fused_ff_train(x: torch.Tensor, ff: FeedForward, dropout_rate: float = 0.0,
                   seed: Optional[int] = None, item0: int = 0) -> torch.Tensor:
    """Differentiable x: (..., C) -> x + dropout(FF(x)), dropout at
    `dropout_rate` from the int `seed` (off when None), x's first item being
    the global batch's item `item0`. CUDA tensors run the training kernels
    (C in SUPPORTED_DIMS, float32 or bfloat16), with the module's parameters
    as inputs of the autograd graph; CPU tensors the plain version."""
    if x.device.type == "cpu":
        return fused_ff_train_ref(x, ff, dropout_rate, seed, item0)
    norm, lin1, _, _, lin2, _ = ff.net
    shape = x.shape
    out = _FusedFFTrain.apply(x.reshape(-1, shape[-1]).contiguous(), norm.gamma, lin1.weight,
                              lin1.bias, lin2.weight, lin2.bias, float(dropout_rate), seed,
                              first_row(x, item0))
    return out.reshape(shape)
