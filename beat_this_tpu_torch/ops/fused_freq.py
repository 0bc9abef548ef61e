"""Fused frequency-axis roformer block: `x + attention(x)`, then the
feed-forward residual, over (items, F, C) with attention across the F bins
of each item.

Counterpart of beat_this_tpu/ops/fused_freq.py:fused_freq_roformer. At eval
(dropout rate 0), on a CUDA tensor `fused_freq_roformer` launches the
hand-written kernel in `csrc/fused_freq.cu`; on a CPU tensor it runs the
plain version `fused_freq_roformer_ref`, the composable path.

`fused_freq_roformer_train` is the training op (the JAX op's custom VJP with
`dropout_rate > 0`): dropout at the four sites of the TPU kernel (attention
probabilities, attention output, FF hidden, FF output), all drawn from one
Philox seed under `ops/dropout.SALT_FREQ`. Its forward is the training
variant of `csrc/fused_freq.cu` and its backward `csrc/fused_freq_train.cu`
(its products on the tensor cores, its FF half the feed-forward backward's
own launches), which recomputes the block from x, so only the inputs are
saved between the passes; `fused_freq_roformer_train_ref` is its plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from beat_this_tpu_torch.model.layers import (
    HEAD_DIM,
    Attention,
    FeedForward,
    attention_block,
    feed_forward,
    rms_norm,
    round_grad,
    round_value,
    rows_mask,
    wide,
)
from beat_this_tpu_torch.ops import _build
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops.fused_ff import (
    dtype_code,
    f32,
    ff_train_branch,
    ff_wgrad_split,
    kernel_weight,
    stream_of,
)
from beat_this_tpu_torch.ops.fused_time import block_params
from beat_this_tpu_torch.ops.rotary import apply_rope
from beat_this_tpu_torch.profiler import op_entry

SUPPORTED_DIMS = (32, 64, 128)


def fused_freq_roformer_ref(x, attn: Attention, ff: FeedForward, rope_cos,
                            rope_sin) -> torch.Tensor:
    """Plain PyTorch version: `x + attention_block`, then `+ feed_forward`."""
    heads = x.shape[-1] // HEAD_DIM
    y = x + attention_block(attn, x, (rope_cos, rope_sin), heads)
    return y + feed_forward(ff, y)


def _check_freq(name: str, x: torch.Tensor) -> int:
    """Raise unless `x` (items, F, C) is a CUDA tensor with C in
    SUPPORTED_DIMS and F dividing 32; returns the dtype code."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {x.device}")
    _, f, c = x.shape
    if c not in SUPPORTED_DIMS or 32 % f:
        raise ValueError(
            f"{name} kernel needs C in {SUPPORTED_DIMS} and F dividing 32, got C={c}, F={f}"
        )
    return dtype_code(x.dtype)


@op_entry
def fused_freq_roformer(x: torch.Tensor, attn: Attention, ff: FeedForward,
                        rope_cos: torch.Tensor, rope_sin: torch.Tensor) -> torch.Tensor:
    """One frequency-axis roformer block over (items, F, C) with C // 32
    heads. rope_cos/rope_sin: (>= F, 16) tables. CUDA tensors run the kernel
    (F dividing 32, C in SUPPORTED_DIMS, float32 or bfloat16); CPU tensors
    the plain version."""
    if x.device.type == "cpu":
        return fused_freq_roformer_ref(x, attn, ff, rope_cos, rope_sin)
    code = _check_freq("fused_freq_roformer", x)
    items, f, c = x.shape
    lib = _build.load_library()
    xc = x.contiguous()
    params = block_params(attn, ff, x.dtype)
    cos, sin = f32(rope_cos[:f]), f32(rope_sin[:f])
    out = torch.empty_like(xc)
    with torch.cuda.device(x.device):
        _build.check(
            lib.bt_fused_freq(
                code, c, xc.data_ptr(), *(p.data_ptr() for p in params),
                cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
                items * f, f, ff.net[1].out_features, stream_of(x),
            ),
            "bt_fused_freq",
        )
    fused_freq_roformer.launches += 1
    return out


fused_freq_roformer.launches = 0


def fused_freq_roformer_train_ref(x, attn: Attention, ff: FeedForward, rope_cos, rope_sin,
                                  dropout_rate: float = 0.0, seed: Optional[int] = None,
                                  item0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the training op: `x + attention branch`,
    then the feed-forward residual, in float32 with the kernels' bfloat16
    rounding points (those of beat_this_tpu/ops/fused_freq.py:
    _fused_freq_kernel and _fused_freq_bwd_kernel).

    Forward: the normed rows, the weights, q/k/v (and q, k after RoPE), the
    dropped unnormalized probabilities, the attention output, the gates and
    the gated output are rounded before their products; the gates come from
    the rounded rows and float32 gate weights, as in the eval kernel; the
    residual x + branch stays float32 into the FF (`ff_train_branch`), and
    the block's output is rounded once. Backward: the cotangents of the
    out projection, of the PV product, of the scores, of the gate logits and
    of q/k/v are rounded before their products.

    Dropout (off when `seed` is None) at the attention probabilities, at
    coordinates (item, head, query, key), and after the out projection and
    at the two FF sites, at coordinates (row of the (items * F, C) view,
    column), all under SALT_FREQ; items count from `item0` and rows from
    item0 * F."""
    dtype = x.dtype
    items, f, c = x.shape
    x32 = wide(x).reshape(items * f, c)
    x2 = x32 + freq_attention_branch(x32, attn, rope_cos, rope_sin, f, dtype, dropout_rate, seed,
                                     item0)
    out = x2 + ff_train_branch(x2, ff, dtype, dropout_rate, seed, drop.SALT_FREQ, item0 * f)
    return out.to(dtype).reshape(items, f, c)


def freq_attention_branch(x32: torch.Tensor, attn: Attention, rope_cos, rope_sin, f: int,
                          dtype: torch.dtype, dropout_rate: float = 0.0,
                          seed: Optional[int] = None, item0: int = 0) -> torch.Tensor:
    """The dropped attention branch of `fused_freq_roformer_train_ref` on the
    float32 (or float64) rows `x32` (items * F, C), with the rounding points
    of the compute dtype `dtype`; the block adds it to x32 unrounded."""
    rows, c = x32.shape
    items, heads = rows // f, c // HEAD_DIM
    acc = x32.dtype
    on = dropout_rate > 0.0 and seed is not None
    g = round_value(rms_norm(x32, attn.norm.gamma), dtype)
    z = round_grad(F.linear(g, attn.to_gates.weight.to(acc)), dtype) + attn.to_gates.bias.to(acc)
    gates = round_value(torch.sigmoid(z), dtype)  # (rows, heads)
    w = round_value(attn.to_qkv.weight.to(acc), dtype)
    qkv = round_value(round_grad(F.linear(g, w), dtype), dtype)
    qkv = qkv.reshape(items, f, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
    cos, sin = rope_cos[:f].to(acc), rope_sin[:f].to(acc)
    q = round_value(apply_rope(qkv[0], cos, sin), dtype)
    k = round_value(apply_rope(qkv[1], cos, sin), dtype)
    v = qkv[2]
    s = round_grad(torch.matmul(q, k.transpose(-1, -2)) * HEAD_DIM**-0.5, dtype)
    p = torch.exp(s - s.amax(-1, keepdim=True).detach())
    l = p.sum(-1, keepdim=True)
    if on:
        with torch.no_grad():
            keep = drop.keep_mask(seed, drop.SALT_FREQ, drop.SITE_ATTN_PROBS, items, heads, f,
                                  f, dropout_rate, x32.device, item0=item0)
        p = p * keep.to(acc)
    o = round_value(round_grad(torch.matmul(round_value(p, dtype), v), dtype) / l, dtype)
    go = round_value(o * gates.reshape(items, f, heads).transpose(1, 2)[..., None], dtype)
    go = go.transpose(1, 2).reshape(rows, c)
    branch = round_grad(F.linear(go, round_value(attn.to_out[0].weight.to(acc), dtype)), dtype)
    if on:
        with torch.no_grad():
            keep = rows_mask(seed, drop.SALT_FREQ, drop.SITE_ATTN_OUT, branch, dropout_rate,
                             item0 * f)
        branch = branch * keep
    return branch


def _train_params(params, dtype) -> list[torch.Tensor]:
    """(agamma, wqkv, wg, gb, wout, fgamma, w1, b1, w2, b2) as the C entry
    points take them: projection weights in the compute dtype, norm gains,
    gate weights and biases in float32."""
    ga, wqkv, wg, gb, wout, gf, w1, b1, w2, b2 = params
    return [f32(ga), kernel_weight(wqkv, dtype), f32(wg), f32(gb), kernel_weight(wout, dtype),
            f32(gf), kernel_weight(w1, dtype), f32(b1), kernel_weight(w2, dtype), f32(b2)]


@op_entry
def freq_train_fwd(x, params, cos, sin, f: int, dropout_rate: float, seed,
                   item0: int = 0) -> torch.Tensor:
    """Launch the training forward on x (items * F, C), its first item the
    global batch's item `item0`, with the ten block parameters `params`
    (torch layouts); returns the block's output."""
    rows, c = x.shape
    code = _check_freq("fused_freq_roformer_train", x.reshape(-1, f, c))
    lib = _build.load_library()
    kp = _train_params(params, x.dtype)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.check(
            lib.bt_freq_train_fwd(
                code, c, x.data_ptr(), *(p.data_ptr() for p in kp), cos.data_ptr(),
                sin.data_ptr(), out.data_ptr(), rows, f, params[6].shape[0],
                *drop.kernel_args(dropout_rate, seed, drop.SALT_FREQ),
                *drop.base_args(item0, item0 * f), stream_of(x),
            ),
            "bt_freq_train_fwd",
        )
    freq_train_fwd.launches += 1
    return out


def freq_bwd_plan(rows: int, c: int, m: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """(rows per group of the attention weight gradients, rows per group of
    the FF's, scratch bytes) of B7 over `rows` rows of width `c`, hidden
    width `m`, in `dtype`: each from `ff_wgrad_split` over the tile count the
    kernel library gives, which also lays out the scratch
    (csrc/fused_freq_train.cu: bt_freq_wgrad_tiles, bt_freq_train_bwd_scratch;
    csrc/fused_ff_train.cu: bt_ff_wgrad_tiles)."""
    lib = _build.load_library()
    tiles, ff_tiles, nbytes = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    _build.check(lib.bt_freq_wgrad_tiles(c, ctypes.byref(tiles)), "bt_freq_wgrad_tiles")
    _build.check(lib.bt_ff_wgrad_tiles(c, m, ctypes.byref(ff_tiles)), "bt_ff_wgrad_tiles")
    group_rows = ff_wgrad_split(rows, tiles.value)
    ff_group_rows = ff_wgrad_split(rows, ff_tiles.value)
    _build.check(lib.bt_freq_train_bwd_scratch(dtype_code(dtype), c, rows, m, group_rows,
                                               ff_group_rows, ctypes.byref(nbytes)),
                 "bt_freq_train_bwd_scratch")
    return group_rows, ff_group_rows, nbytes.value


@op_entry
def freq_train_bwd(x, params, cos, sin, f: int, dout, dropout_rate: float, seed,
                   item0: int = 0):
    """Launch the training backward; returns dx and the ten parameter
    gradients (float32, torch layouts, the order of `params`). The library
    lays out the scratch (`freq_bwd_plan`: the recomputed attention half,
    float32 x2 and d_x2, the FF half's operands, the attention branch's
    cotangents as operands, the partials of the weight gradients)."""
    rows, c = x.shape
    m = params[6].shape[0]
    code = _check_freq("fused_freq_roformer_train", x.reshape(-1, f, c))
    lib = _build.load_library()
    dev, dtype = x.device, x.dtype
    group_rows, ff_group_rows, nbytes = freq_bwd_plan(rows, c, m, dtype)
    kp = _train_params(params, dtype)[:9]  # b2 has no part in the backward
    dout = dout.to(dtype).contiguous()
    dx = torch.empty_like(x)
    grads = [torch.empty(p.shape, dtype=torch.float32, device=dev) for p in params]
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _build.check(
            lib.bt_freq_train_bwd(
                code, c, x.data_ptr(), *(p.data_ptr() for p in kp), cos.data_ptr(),
                sin.data_ptr(), dout.data_ptr(), dx.data_ptr(),
                *(g.data_ptr() for g in grads), scratch.data_ptr(), nbytes, rows, f, m,
                group_rows, ff_group_rows, *drop.kernel_args(dropout_rate, seed, drop.SALT_FREQ),
                *drop.base_args(item0, item0 * f), stream_of(x),
            ),
            "bt_freq_train_bwd",
        )
    freq_train_bwd.launches += 1
    return (dx, *grads)


freq_train_fwd.launches = 0
freq_train_bwd.launches = 0


class _FusedFreqTrain(torch.autograd.Function):
    """x (items * F, C) and the block's ten parameters -> the block's output
    with dropout; the backward recomputes the block from x and regenerates
    the masks from `seed`."""

    @staticmethod
    def forward(ctx, x, ga, wqkv, wg, gb, wout, gf, w1, b1, w2, b2, cos, sin, f, dropout_rate,
                seed, item0):
        params = (ga, wqkv, wg, gb, wout, gf, w1, b1, w2, b2)
        ctx.save_for_backward(x, cos, sin, *params)
        ctx.f, ctx.dropout_rate, ctx.seed, ctx.item0 = f, dropout_rate, seed, item0
        return freq_train_fwd(x, params, cos, sin, f, dropout_rate, seed, item0)

    @staticmethod
    def backward(ctx, dout):
        x, cos, sin, *params = ctx.saved_tensors
        dx, *grads = freq_train_bwd(x, params, cos, sin, ctx.f, dout, ctx.dropout_rate,
                                    ctx.seed, ctx.item0)
        return (dx, *(g.to(p.dtype) for g, p in zip(grads, params)), None, None, None, None,
                None, None)


def fused_freq_roformer_train(x: torch.Tensor, attn: Attention, ff: FeedForward,
                              rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                              dropout_rate: float = 0.0, seed: Optional[int] = None,
                              item0: int = 0) -> torch.Tensor:
    """Differentiable training block over (items, F, C), C // 32 heads, with
    dropout at `dropout_rate` from the int `seed` (off when None), x's first
    item being the global batch's item `item0`. CUDA
    tensors run the training kernels (F dividing 32, C in SUPPORTED_DIMS,
    float32 or bfloat16), with the modules' parameters as inputs of the
    autograd graph; CPU tensors the plain version."""
    if x.device.type == "cpu":
        return fused_freq_roformer_train_ref(x, attn, ff, rope_cos, rope_sin, dropout_rate,
                                             seed, item0)
    items, f, c = x.shape
    norm, lin1, _, _, lin2, _ = ff.net
    out = _FusedFreqTrain.apply(
        x.reshape(items * f, c).contiguous(), attn.norm.gamma, attn.to_qkv.weight,
        attn.to_gates.weight, attn.to_gates.bias, attn.to_out[0].weight, norm.gamma,
        lin1.weight, lin1.bias, lin2.weight, lin2.bias, f32(rope_cos[:f]), f32(rope_sin[:f]),
        f, float(dropout_rate), seed, int(item0))
    return out.reshape(items, f, c)
