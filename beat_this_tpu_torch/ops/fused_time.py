"""Fused time-axis roformer block (eval): `x + attention(x)`, then the
feed-forward residual, over (items, n, C).

Counterpart of beat_this_tpu/ops/fused_time.py:fused_time_roformer. On a
CUDA tensor `fused_time_roformer` launches the hand-written kernels of
`csrc/fused_time.cu` (weight operands; norm and gates; q/k/v with RoPE; the
attention core; out projection + residual; the feed-forward residual's
three launches), every product on the tensor cores, with the intermediates
in a scratch buffer whose size the library gives; on a CPU tensor it runs
the plain version `fused_time_roformer_ref`, the composable path.

`fused_time_attention_train` is the training twin of the attention branch
(fused_time.py:fused_time_attention_train): dropout on the attention
probabilities and after the out projection from a Philox seed
(`ops/dropout.py`), and a flash-style backward (`csrc/fused_time_train.cu`),
every product on the tensor cores (float32 as split bf16 products). It
saves O(n C) tensors between the passes (q, k, v, gates, the normalized
attention output and each row's softmax max and sum), never an (n, n) one;
each pass asks the kernel library for its scratch size.
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
from beat_this_tpu_torch.ops.rotary import apply_rope
from beat_this_tpu_torch.ops.fused_ff import (
    SUPPORTED_DIMS,
    dtype_code,
    eval_scratch,
    f32,
    ff_params,
    ff_wgrad_split,
    kernel_weight,
    stream_of,
)
from beat_this_tpu_torch.profiler import op_entry


def block_params(attn: Attention, ff: FeedForward, dtype: torch.dtype) -> list[torch.Tensor]:
    """A roformer block's parameters as the C entry points take them, in
    their order (agamma, wqkv, wg, gb, wout, then `ff_params`): projection
    weights in the compute dtype, norm gains and the gate in float32."""
    return [
        f32(attn.norm.gamma), kernel_weight(attn.to_qkv.weight, dtype),
        f32(attn.to_gates.weight), f32(attn.to_gates.bias),
        kernel_weight(attn.to_out[0].weight, dtype),
    ] + ff_params(ff, dtype)


def _check_time(name: str, x: torch.Tensor, heads: int) -> int:
    """Raise unless `x` (items, n, C) is a CUDA tensor with C == heads * 32
    in SUPPORTED_DIMS; returns the dtype code."""
    c = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {x.device}")
    if c != heads * HEAD_DIM or c not in SUPPORTED_DIMS:
        raise ValueError(
            f"{name} kernel needs C == heads * {HEAD_DIM} in {SUPPORTED_DIMS}, "
            f"got C={c}, heads={heads}"
        )
    return dtype_code(x.dtype)


def fused_time_roformer_ref(x, attn: Attention, ff: FeedForward, rope_cos, rope_sin,
                            heads: int) -> torch.Tensor:
    """Plain PyTorch version: `x + attention_block`, then `+ feed_forward`."""
    y = x + attention_block(attn, x, (rope_cos, rope_sin), heads)
    return y + feed_forward(ff, y)


@op_entry
def fused_time_roformer(x: torch.Tensor, attn: Attention, ff: FeedForward,
                        rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """One whole pre-norm roformer block over (items, n, C), C == heads * 32.
    rope_cos/rope_sin: (>= n, 16) tables. CUDA tensors run the kernels (C in
    SUPPORTED_DIMS, float32 or bfloat16); CPU tensors the plain version."""
    if x.device.type == "cpu":
        return fused_time_roformer_ref(x, attn, ff, rope_cos, rope_sin, heads)
    code = _check_time("fused_time_roformer", x, heads)
    items, n, c = x.shape
    m = ff.net[1].out_features
    lib = _build.load_library()
    xc = x.contiguous()
    params = block_params(attn, ff, torch.float32)  # the kernel rounds the weights itself
    cos, sin = f32(rope_cos[:n]), f32(rope_sin[:n])
    out = torch.empty_like(xc)
    nbytes = eval_scratch("bt_fused_time_scratch", code, c, items * n, m)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        _build.check(
            lib.bt_fused_time(
                code, c, xc.data_ptr(), *(p.data_ptr() for p in params),
                cos.data_ptr(), sin.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                nbytes, items, n, m, stream_of(x),
            ),
            "bt_fused_time",
        )
    fused_time_roformer.launches += 1
    return out


fused_time_roformer.launches = 0


def fused_time_attention_train_ref(x, attn: Attention, rope_cos, rope_sin, heads: int,
                                   dropout_rate: float = 0.0, seed: Optional[int] = None,
                                   item0: int = 0) -> torch.Tensor:
    """Plain PyTorch version: `attention_block` with dropout, in float32 with
    the kernel's bfloat16 rounding points. Forward: the normed rows, the
    weights, q/k/v after RoPE, the dropped probabilities and the gated
    output rounded before their products (gates from the float32 rows),
    the branch rounded once. Backward: the cotangents of the out projection,
    of the PV product, of the scores and of q/k/v rounded before their
    products."""
    dtype = x.dtype
    b, n, c = x.shape
    x32 = wide(x)
    acc = x32.dtype
    gn = rms_norm(x32, attn.norm.gamma)
    gates = torch.sigmoid(F.linear(gn, attn.to_gates.weight.to(acc),
                                   attn.to_gates.bias.to(acc)))  # (b, n, heads)
    w = round_value(attn.to_qkv.weight.to(acc), dtype)
    qkv = round_grad(F.linear(round_value(gn, dtype), w), dtype)
    qkv = qkv.reshape(b, n, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
    cos, sin = rope_cos[:n], rope_sin[:n]
    q = round_value(apply_rope(qkv[0], cos, sin), dtype)
    k = round_value(apply_rope(qkv[1], cos, sin), dtype)
    v = round_value(qkv[2], dtype)
    s = round_grad(torch.matmul(q, k.transpose(-1, -2)) * HEAD_DIM**-0.5, dtype)
    p = torch.exp(s - s.amax(-1, keepdim=True).detach())
    l = p.sum(-1, keepdim=True)
    on = dropout_rate > 0.0 and seed is not None
    if on:
        with torch.no_grad():
            keep = drop.keep_mask(seed, drop.SALT_ATTN, drop.SITE_ATTN_PROBS, b, heads, n, n,
                                  dropout_rate, x.device, item0=item0)
        p = p * keep.to(acc)
    o = round_grad(torch.matmul(round_value(p, dtype), v), dtype) / l  # (b, heads, n, 32)
    go = round_value(o * gates.transpose(1, 2)[..., None], dtype)
    go = go.transpose(1, 2).reshape(b, n, c)
    out = round_grad(F.linear(go, round_value(attn.to_out[0].weight.to(acc), dtype)), dtype)
    if on:
        with torch.no_grad():
            keep = rows_mask(seed, drop.SALT_ATTN, drop.SITE_ATTN_OUT, out, dropout_rate,
                             item0 * n)
        out = out * keep
    return out.to(dtype)


def attn_fwd_scratch(rows: int, c: int, dtype: torch.dtype) -> int:
    """Bytes of B4's scratch over `rows` rows of width `c` in `dtype`, as
    the kernel library lays it out (csrc/fused_time_train.cu:
    bt_attn_train_fwd_scratch)."""
    lib = _build.load_library()
    nbytes = ctypes.c_longlong()
    _build.check(lib.bt_attn_train_fwd_scratch(dtype_code(dtype), c, rows, ctypes.byref(nbytes)),
                 "bt_attn_train_fwd_scratch")
    return nbytes.value


def attn_bwd_plan(rows: int, c: int, dtype: torch.dtype) -> tuple[int, int]:
    """(rows per weight-gradient group, scratch bytes) of B5 over `rows`
    rows of width `c` in `dtype`: the library gives the output tiles of its
    weight-gradient launch per group and lays out the scratch
    (bt_attn_wgrad_tiles, bt_attn_train_bwd_scratch); the groups follow
    B9's rule (`ff_wgrad_split`)."""
    lib = _build.load_library()
    tiles, nbytes = ctypes.c_int(), ctypes.c_longlong()
    _build.check(lib.bt_attn_wgrad_tiles(c, ctypes.byref(tiles)), "bt_attn_wgrad_tiles")
    group_rows = ff_wgrad_split(rows, tiles.value)
    _build.check(lib.bt_attn_train_bwd_scratch(dtype_code(dtype), c, rows, group_rows,
                                               ctypes.byref(nbytes)),
                 "bt_attn_train_bwd_scratch")
    return group_rows, nbytes.value


@op_entry
def attn_train_fwd(x, gamma, wqkv, wg, gb, wout, cos, sin, heads, dropout_rate, seed,
                   item0: int = 0):
    """Launch the training forward on x (items, n, C), its first item the
    global batch's item `item0`; returns the branch and the tensors the
    backward reads (q, k, v, gates, o, row max, row sum)."""
    code = _check_time("fused_time_attention_train", x, heads)
    items, n, c = x.shape
    lib = _build.load_library()
    dev, dtype = x.device, x.dtype
    params = [f32(gamma), kernel_weight(wqkv, dtype), f32(wg), f32(gb),
              kernel_weight(wout, dtype), cos, sin]
    saved = [torch.empty((items, heads, n, HEAD_DIM), dtype=dtype, device=dev) for _ in range(3)]
    saved += [torch.empty((items * n, heads), dtype=torch.float32, device=dev),
              torch.empty((items, n, c), dtype=torch.float32, device=dev),
              torch.empty((items * heads, n), dtype=torch.float32, device=dev),
              torch.empty((items * heads, n), dtype=torch.float32, device=dev)]
    out = torch.empty_like(x)
    nbytes = attn_fwd_scratch(items * n, c, dtype)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _build.check(
            lib.bt_attn_train_fwd(
                code, c, x.data_ptr(), *(p.data_ptr() for p in params),
                *(t.data_ptr() for t in saved), out.data_ptr(), scratch.data_ptr(), nbytes,
                items, n, *drop.kernel_args(dropout_rate, seed, drop.SALT_ATTN),
                *drop.base_args(item0, item0 * n), stream_of(x),
            ),
            "bt_attn_train_fwd",
        )
    attn_train_fwd.launches += 1
    return out, saved


@op_entry
def attn_train_bwd(x, gamma, wqkv, wg, wout, cos, sin, saved, dout, heads, dropout_rate,
                   seed, item0: int = 0):
    """Launch the training backward; returns (dx, dgamma, dwqkv, dwg, dgb,
    dwout), the parameter gradients in float32 and torch's layouts."""
    code = _check_time("fused_time_attention_train", x, heads)
    items, n, c = x.shape
    lib = _build.load_library()
    dev, dtype = x.device, x.dtype
    group_rows, nbytes = attn_bwd_plan(items * n, c, dtype)
    params = [f32(gamma), kernel_weight(wqkv, dtype), f32(wg), kernel_weight(wout, dtype),
              cos, sin]
    dout = dout.to(dtype).contiguous()
    dx = torch.empty_like(x)
    grads = [torch.empty(shape, dtype=torch.float32, device=dev)
             for shape in ((c,), (4 * c, c), (heads, c), (heads,))]
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _build.check(
            lib.bt_attn_train_bwd(
                code, c, x.data_ptr(), *(p.data_ptr() for p in params),
                *(t.data_ptr() for t in saved), dout.data_ptr(), dx.data_ptr(),
                *(g.data_ptr() for g in grads), scratch.data_ptr(), nbytes, items, n,
                group_rows, *drop.kernel_args(dropout_rate, seed, drop.SALT_ATTN),
                *drop.base_args(item0, item0 * n), stream_of(x),
            ),
            "bt_attn_train_bwd",
        )
    attn_train_bwd.launches += 1
    dgamma, dw, dwg, dgb = grads
    return dx, dgamma, dw[: 3 * c], dwg, dgb, dw[3 * c:]


attn_train_fwd.launches = 0
attn_train_bwd.launches = 0


class _FusedTimeAttnTrain(torch.autograd.Function):
    """x (items, n, C) and the attention parameters -> the dropped attention
    branch; the backward regenerates the masks from `seed`."""

    @staticmethod
    def forward(ctx, x, gamma, wqkv, wg, gb, wout, cos, sin, heads, dropout_rate, seed, item0):
        out, saved = attn_train_fwd(x, gamma, wqkv, wg, gb, wout, cos, sin, heads,
                                    dropout_rate, seed, item0)
        ctx.save_for_backward(x, gamma, wqkv, wg, wout, cos, sin, *saved)
        ctx.heads, ctx.dropout_rate, ctx.seed, ctx.gb_dtype = heads, dropout_rate, seed, gb.dtype
        ctx.item0 = item0
        return out

    @staticmethod
    def backward(ctx, dout):
        x, gamma, wqkv, wg, wout, cos, sin, *saved = ctx.saved_tensors
        dx, dgamma, dwqkv, dwg, dgb, dwout = attn_train_bwd(
            x, gamma, wqkv, wg, wout, cos, sin, saved, dout, ctx.heads, ctx.dropout_rate,
            ctx.seed, ctx.item0)
        return (dx, dgamma.to(gamma.dtype), dwqkv.to(wqkv.dtype), dwg.to(wg.dtype),
                dgb.to(ctx.gb_dtype), dwout.to(wout.dtype), None, None, None, None, None, None)


def fused_time_attention_train(x: torch.Tensor, attn: Attention, rope_cos: torch.Tensor,
                               rope_sin: torch.Tensor, heads: int, dropout_rate: float = 0.0,
                               seed: Optional[int] = None, item0: int = 0) -> torch.Tensor:
    """Differentiable attention residual branch over (items, n, C) (the
    caller adds x), C == heads * 32, with dropout at `dropout_rate` from the
    int `seed` (off when None), x's first item being the global batch's item
    `item0`. CUDA tensors run the training kernels (C in
    SUPPORTED_DIMS, float32 or bfloat16), with the module's parameters as
    inputs of the autograd graph; CPU tensors the plain version."""
    if x.device.type == "cpu":
        return fused_time_attention_train_ref(x, attn, rope_cos, rope_sin, heads,
                                              dropout_rate, seed, item0)
    n = x.shape[1]
    return _FusedTimeAttnTrain.apply(
        x.contiguous(), attn.norm.gamma, attn.to_qkv.weight, attn.to_gates.weight,
        attn.to_gates.bias, attn.to_out[0].weight, f32(rope_cos[:n]), f32(rope_sin[:n]),
        heads, float(dropout_rate), seed, int(item0))
