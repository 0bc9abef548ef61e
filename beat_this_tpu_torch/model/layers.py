"""Building blocks of the BeatThis model, PyTorch counterpart of
beat_this_tpu/model/layers.py.

Modules hold the parameters under the reference's names
(beat_this/model/roformer.py): `RMSNorm.gamma`; `Attention.norm`, `.to_qkv`,
`.to_gates`, `.to_out.0`; `FeedForward.net.{0,1,4}`. Weights keep torch's
Linear layout (out_features, in_features), and conv weights the reference's
OIHW layout with H = frequency and W = time.

The functions keep the JAX package's activation layout: sequences are
(items, seq, C) and frontend activations (batch, time, freq, C). The
routers `ff_residual`, `freq_roformer` and `time_roformer` take the fused
kernels under the same conditions as the JAX routers, and otherwise (or
with `kernels=False`) the composable path, which is also what the kernels'
plain versions compute. In training (`time_attention_train`,
`ff_residual(train=True)`) the same holds for the training kernels. Where
the fused routers decline a shape (a head width other than 32),
`attention_block` routes the attention itself as the JAX package does:
unmasked sequences of at least FLASH_MIN_SEQ frames to `flash_attention`,
unmasked sequences whose length divides 128 and is at most 32 to
`small_attention` (both with the rotation inside), anything else (masked
short pieces) to the rotation and `sdpa` in plain torch.

Dropout draws its masks from `ops/dropout.py` (Philox keyed by an int
`seed` per call): the composable path and the kernels drop the same
elements for the same seed. `item0` is the global index of a call's first
item (leading axis): a shard of a data-parallel batch draws the bits of its
items in the whole batch's masks (0 for a whole batch). Float64 inputs are
computed in float64 (for gradchecks); other dtypes accumulate norms and
softmax in float32. The
training kernels' plain versions (ops/fused_ff.py, ops/fused_time.py)
compute in float32 and round to bfloat16, forward and backward, where the
kernels round (`round_value`, `round_grad`). With `kernels=False` each
training branch is recomputed in the backward (`recomputed`, or chunk by
chunk inside `flash_attention_ref`), so the plain path keeps no (T, T)
probability matrix between the passes.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops.rotary import apply_rope

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
# time-axis sequences at least this long take the fused time kernel or, in
# `attention_block`, `flash_attention`
FLASH_MIN_SEQ = 512
HEAD_DIM = 32
# the JAX router's cap on heads for the fused attention training kernel
FUSED_TIME_TRAIN_MAX_HEADS = 16


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Attention(nn.Module):
    """Pre-norm gated rotary attention (reference roformer.Attention)."""

    def __init__(self, dim: int, heads: int, head_dim: int = HEAD_DIM):
        super().__init__()
        inner = heads * head_dim
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_gates = nn.Linear(dim, heads)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, bias=False))


class FeedForward(nn.Module):
    """Pre-norm MLP with exact GELU (reference roformer.FeedForward); the
    parameter-free entries keep the reference's Sequential indices."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(
            RMSNorm(dim),
            nn.Linear(dim, dim * mult),
            nn.GELU(),
            nn.Identity(),
            nn.Linear(dim * mult, dim),
            nn.Identity(),
        )


class BatchNorm(nn.Module):
    """Batch-norm parameters and running statistics under torch's names
    (weight, bias, running_mean, running_var); see `batch_norm_apply`."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))


def wide(t: torch.Tensor) -> torch.Tensor:
    """`t` in its accumulation dtype: float64 stays, the rest is float32."""
    return t if t.dtype == torch.float64 else t.float()


class _RoundValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dtype):
        return t.to(dtype).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dtype):
        ctx.dtype = dtype
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def _narrower(t: torch.Tensor, dtype: torch.dtype) -> bool:
    return dtype in (torch.bfloat16, torch.float16) and t.dtype != dtype


def round_value(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` rounded to `dtype` and kept in its own dtype; the gradient passes
    unrounded. The training plain versions round where the kernels round."""
    return _RoundValue.apply(t, dtype) if _narrower(t, dtype) else t


def round_grad(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` unchanged; its gradient is rounded to `dtype` on the way back
    (where a kernel's backward rounds a cotangent before its products)."""
    return _RoundGrad.apply(t, dtype) if _narrower(t, dtype) else t


def rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """`F.normalize(x, dim=-1) * sqrt(dim) * gamma`, computed in float32 (or
    float64) and returned in the dtype of `x`."""
    dim = x.shape[-1]
    x32 = wide(x)
    norm = torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True))
    out = x32 / torch.clamp_min(norm, 1e-12) * (dim**0.5) * gamma.to(x32.dtype)
    return out.to(x.dtype)


def sdpa(q, k, v, *, key_mask: Optional[torch.Tensor] = None,
         dropmask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention over (..., heads, seq, head_dim): scale
    head_dim^-0.5, float32 scores and softmax. `key_mask` (batch, seq) bool:
    False keys get probability zero. `dropmask` (..., heads, seq, seq): the
    dropout keep factors applied to the probabilities."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(wide(q), wide(k).transpose(-1, -2)) * scale
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if dropmask is not None:
        probs = probs * dropmask.to(probs.dtype)
    return torch.matmul(wide(probs.to(q.dtype)), wide(v)).to(q.dtype)


def rows_mask(seed: int, salt: int, site: int, h: torch.Tensor, rate: float, row0: int = 0):
    """Keep factors over `h` viewed as (rows, C), its rows counted from
    `row0`, shaped and typed as `h`."""
    rows = h.numel() // h.shape[-1]
    m = drop.keep_mask(seed, salt, site, 1, 1, rows, h.shape[-1], rate, h.device, row0=row0)
    return m.reshape(h.shape).to(h.dtype)


def attention_block(
    attn: Attention,
    x: torch.Tensor,
    rope: tuple[torch.Tensor, torch.Tensor],
    heads: int,
    *,
    key_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    kernels: bool = True,
    item0: int = 0,
) -> torch.Tensor:
    """The attention residual branch on (b, n, C) (the caller adds x). With
    `dropout_rate > 0` and a `seed`: dropout on the attention probabilities
    and after the out projection (torch placement). The attention itself
    follows the JAX router (beat_this_tpu/model/layers.py:155-191): unmasked
    and n >= FLASH_MIN_SEQ: `flash_attention`; unmasked, n <= 32 and n
    divides 128: `small_attention` (both rotate q and k inside, run their
    CUDA kernels on CUDA tensors and their plain versions on CPU tensors or
    with `kernels=False`); otherwise the rotation and `sdpa` in plain torch.
    All three draw the same probability mask for the same seed."""
    b, n, _ = x.shape
    on = dropout_rate > 0.0 and seed is not None
    rate = dropout_rate if on else 0.0
    g = rms_norm(x, attn.norm.gamma)
    qkv = F.linear(g, attn.to_qkv.weight.to(g.dtype))
    inner = qkv.shape[-1] // 3
    head_dim = inner // heads
    # torch layout "(qkv h d)": qkv slowest, then head, then head_dim
    qkv = qkv.reshape(b, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    cos, sin = rope
    fn = None
    if key_mask is None and n >= FLASH_MIN_SEQ:
        from beat_this_tpu_torch.ops import flash_attention as ops

        fn = ops.flash_attention if kernels else ops.flash_attention_ref
    elif key_mask is None and n <= 32 and 128 % n == 0:
        from beat_this_tpu_torch.ops import small_attention as ops

        fn = ops.small_attention if kernels else ops.small_attention_ref
    if fn is not None:
        q, k, v = (t.reshape(b * heads, n, head_dim) for t in qkv)
        out = fn(q, k, v, cos, sin, rate, seed, heads, item0).reshape(b, heads, n, head_dim)
    else:
        dropmask = None
        if on:
            with torch.no_grad():
                dropmask = drop.keep_mask(seed, drop.SALT_ATTN, drop.SITE_ATTN_PROBS, b, heads,
                                          n, n, dropout_rate, x.device, item0=item0)
        out = sdpa(apply_rope(qkv[0], cos, sin), apply_rope(qkv[1], cos, sin), qkv[2],
                   key_mask=key_mask, dropmask=dropmask)  # (b, heads, n, head_dim)
    gates = F.linear(
        g, attn.to_gates.weight.to(g.dtype), attn.to_gates.bias.to(g.dtype)
    )
    out = out * torch.sigmoid(gates.transpose(1, 2))[..., None]
    out = out.transpose(1, 2).reshape(b, n, inner)
    out = F.linear(out, attn.to_out[0].weight.to(out.dtype))
    if on:
        with torch.no_grad():
            keep = rows_mask(seed, drop.SALT_ATTN, drop.SITE_ATTN_OUT, out, dropout_rate,
                             item0 * n)
        out = out * keep
    return out


def feed_forward(ff: FeedForward, x: torch.Tensor) -> torch.Tensor:
    """The feed-forward residual branch at eval (the caller adds x); training
    goes through `ff_residual(train=True)`."""
    norm, lin1, _, _, lin2, _ = ff.net
    g = rms_norm(x, norm.gamma)
    h = F.gelu(F.linear(g, lin1.weight.to(g.dtype), lin1.bias.to(g.dtype)))
    return F.linear(h, lin2.weight.to(h.dtype), lin2.bias.to(h.dtype))


def recomputed(fn, *args, **kwargs):
    """`fn(*args, **kwargs)` under `torch.utils.checkpoint`: the backward recomputes
    the branch instead of keeping its activations, as the JAX package's
    composable training path does with `jax.checkpoint`
    (beat_this_tpu/model/beat_this.py:289-308). The plain frontend attention
    of one microbatch would otherwise keep several (256, 1, 1500, 1500)
    float32 tensors of 2.3 GB per block. The values are unchanged: the
    dropout masks follow from the seed."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kwargs)


def at(item0: int) -> dict:
    """The keyword arguments that place a training op's items in the global
    batch: none for a whole batch (item0 0)."""
    return {"item0": item0} if item0 else {}


def ff_residual(ff: FeedForward, x: torch.Tensor, *, kernels: bool = True,
                train: bool = False, dropout_rate: float = 0.0,
                seed: Optional[int] = None, item0: int = 0):
    """`x + feed_forward(x)`: at eval the fused_ff kernel when `kernels`; in
    training (`train=True`) the fused_ff_train kernel, or its plain version
    without `kernels`, with dropout at `dropout_rate` from `seed`."""
    if train:
        from beat_this_tpu_torch.ops import fused_ff

        if kernels:
            return fused_ff.fused_ff_train(x, ff, dropout_rate, seed, **at(item0))
        return recomputed(fused_ff.fused_ff_train_ref, x, ff, dropout_rate, seed, **at(item0))
    if kernels:
        from beat_this_tpu_torch.ops.fused_ff import fused_ff

        return fused_ff(x, ff)
    return x + feed_forward(ff, x)


def time_attention_train(attn: Attention, x: torch.Tensor, rope, heads: int, *,
                         dropout_rate: float = 0.0, seed: Optional[int] = None,
                         kernels: bool = True, item0: int = 0) -> torch.Tensor:
    """The training attention residual branch on (items, T, C) (the caller
    adds x): the fused attention training kernel when `kernels`,
    T >= FLASH_MIN_SEQ, C == heads * 32, heads is 1, 2 or a multiple of 4 and
    at most FUSED_TIME_TRAIN_MAX_HEADS (the JAX router's conditions);
    otherwise `attention_block`, whose own kernels then run the attention.
    `kernels=False` takes the plain version where a kernel would run,
    recomputed in the backward."""
    if (
        x.shape[1] >= FLASH_MIN_SEQ
        and x.shape[-1] == heads * HEAD_DIM
        and (heads <= 2 or heads % 4 == 0)
        and heads <= FUSED_TIME_TRAIN_MAX_HEADS
    ):
        from beat_this_tpu_torch.ops import fused_time

        if kernels:
            return fused_time.fused_time_attention_train(x, attn, rope[0], rope[1], heads,
                                                         dropout_rate, seed, **at(item0))
        return recomputed(fused_time.fused_time_attention_train_ref, x, attn, rope[0], rope[1],
                          heads, dropout_rate, seed, **at(item0))
    return attention_train(attn, x, rope, heads, dropout_rate=dropout_rate, seed=seed,
                           kernels=kernels, item0=item0)


def attention_train(attn: Attention, x: torch.Tensor, rope, heads: int, *, dropout_rate: float,
                    seed: Optional[int], kernels: bool, item0: int = 0) -> torch.Tensor:
    """`attention_block` in training. With `kernels` as it is: its attention
    kernels keep O(n) per query between the passes. Without, no (n, n)
    tensor is kept either: sequences of at least FLASH_MIN_SEQ frames go
    through `flash_attention_ref`, which recomputes its own chunks in the
    backward, and a shorter block is recomputed as a whole (`recomputed`)."""
    run = attention_block
    if not kernels and x.shape[1] < FLASH_MIN_SEQ:
        run = functools.partial(recomputed, attention_block)
    return run(attn, x, rope, heads, dropout_rate=dropout_rate, seed=seed, kernels=kernels,
               item0=item0)


def split_seed(seed: Optional[int]) -> tuple[Optional[int], Optional[int]]:
    """Two int32 seeds drawn from one (None stays None), as JAX splits an
    rng in two."""
    if seed is None:
        return None, None
    gen = torch.Generator().manual_seed(int(seed))
    a, b = torch.randint(0, 2**31 - 1, (2,), generator=gen).tolist()
    return a, b


def freq_roformer(attn, ff, x, rope, heads, *, kernels: bool = True, train: bool = False,
                  dropout_rate: float = 0.0, seed: Optional[int] = None, item0: int = 0):
    """One frequency-axis roformer block on (items, F, C):
    `x + attention; + feed_forward`. Where the JAX router fuses (F divides
    128, at most 32, and C == heads * 32): at eval the fused kernel when
    `kernels`; in training (`train=True`) the fused training op with
    dropout at `dropout_rate` from the one `seed`, or its plain version
    without `kernels` (recomputed in the backward). Otherwise
    `attention_block` plus `ff_residual`, in training with `seed` split in
    two."""
    f = x.shape[1]
    fused = f <= 32 and 128 % f == 0 and x.shape[-1] == heads * HEAD_DIM
    if fused and train:
        from beat_this_tpu_torch.ops import fused_freq

        if kernels:
            return fused_freq.fused_freq_roformer_train(x, attn, ff, rope[0], rope[1],
                                                        dropout_rate, seed, **at(item0))
        return recomputed(fused_freq.fused_freq_roformer_train_ref, x, attn, ff, rope[0],
                          rope[1], dropout_rate, seed, **at(item0))
    if fused and kernels:
        from beat_this_tpu_torch.ops.fused_freq import fused_freq_roformer

        return fused_freq_roformer(x, attn, ff, rope[0], rope[1])
    if train:
        seed_a, seed_f = split_seed(seed)
        x = x + attention_train(attn, x, rope, heads, dropout_rate=dropout_rate, seed=seed_a,
                                kernels=kernels, item0=item0)
        return ff_residual(ff, x, kernels=kernels, train=True, dropout_rate=dropout_rate,
                           seed=seed_f, item0=item0)
    x = x + attention_block(attn, x, rope, heads, kernels=kernels)
    return ff_residual(ff, x, kernels=kernels)


def time_roformer(attn, ff, x, rope, heads, *, kernels: bool = True):
    """One time-axis roformer block on (items, T, C) at eval:
    `x + attention; + feed_forward`, as the fused time kernel when `kernels`,
    T >= FLASH_MIN_SEQ, C == heads * 32 and heads is 1, 2 or a multiple of 4
    (the JAX router's conditions)."""
    if (
        kernels
        and x.shape[1] >= FLASH_MIN_SEQ
        and x.shape[-1] == heads * HEAD_DIM
        and (heads <= 2 or heads % 4 == 0)
    ):
        from beat_this_tpu_torch.ops.fused_time import fused_time_roformer

        return fused_time_roformer(x, attn, ff, rope[0], rope[1], heads)
    x = x + attention_block(attn, x, rope, heads, kernels=kernels)
    return ff_residual(ff, x, kernels=kernels)


def partial_roformer(attn: Attention, ff: FeedForward, x: torch.Tensor, direction: str,
                     head_dim: int, *, kernels: bool = True, train: bool = False,
                     dropout_rate: float = 0.0, seed: Optional[int] = None,
                     batch0: int = 0) -> torch.Tensor:
    """Single-direction partial roformer on (batch, time, freq, C): attention
    plus feed-forward across only the frequency axis ("f") or only the time
    axis ("t"), counterpart of beat_this_tpu/model/layers.py:partial_roformer
    (the reference's PartialRoformer, which the stock model does not use).
    The attention is `attention_block`; the feed-forward goes through
    `ff_residual`, the port's one route to `x + feed_forward(x)`. In training
    (`train=True`) `seed` is split in two, one for each half; `batch0` is
    the global index of x's first batch row."""
    from beat_this_tpu_torch.ops.rotary import rope_tables

    direction = direction[0].lower()
    if direction not in "ft":
        raise ValueError(f"direction must be F or T, got {direction}")
    b, t, f, c = x.shape
    heads = c // head_dim
    if direction == "f":
        h = x.reshape(b * t, f, c)
    else:
        h = x.transpose(1, 2).reshape(b * f, t, c)
    item0 = batch0 * (h.shape[0] // b)
    rope = rope_tables(h.shape[1], head_dim, x.device)
    if train:
        seed_a, seed_f = split_seed(seed)
        h = h + attention_train(attn, h, rope, heads, dropout_rate=dropout_rate, seed=seed_a,
                                kernels=kernels, item0=item0)
        h = ff_residual(ff, h, kernels=kernels, train=True, dropout_rate=dropout_rate,
                        seed=seed_f, item0=item0)
    else:
        h = h + attention_block(attn, h, rope, heads, kernels=kernels)
        h = ff_residual(ff, h, kernels=kernels)
    if direction == "f":
        return h.reshape(b, t, f, c)
    return h.reshape(b, f, t, c).transpose(1, 2)


def batch_norm_apply(bn: BatchNorm, x: torch.Tensor, *, train: bool = False,
                     group=None) -> torch.Tensor:
    """Batch norm over the last axis in float32, returned in the dtype of
    `x`. Eval folds the running statistics into one scale and shift. Train
    normalizes with the batch mean and biased variance and updates the
    running statistics in place (unbiased variance, momentum 0.1), as torch
    BatchNorm and beat_this_tpu/model/layers.py:422-436.

    `group` (training only): a torch.distributed process group whose ranks
    each hold a shard of one batch. The per-channel sums, sums of squares
    and counts are then all-reduced, differentiably (the backward
    all-reduces their cotangents), so the ranks normalize by the whole
    batch's statistics, as `jnp.mean` over a sharded batch does in the JAX
    package, and the averaged gradients equal the one-process gradient."""
    x32 = x.float()
    if not train:
        mean, var = bn.running_mean.float(), bn.running_var.float()
    else:
        axes = tuple(range(x.ndim - 1))
        if group is None:
            mean = x32.mean(axes)
            var = x32.square().mean(axes) - mean.square()
            count = x.numel() // x.shape[-1]
        else:
            mean, var, count = _global_moments(x32, axes, group)
        with torch.no_grad():
            bn.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            bn.running_var.mul_(1 - BN_MOMENTUM).add_(
                BN_MOMENTUM * var * (count / max(count - 1, 1)))
    scale = bn.weight.float() * torch.rsqrt(var + BN_EPS)
    shift = bn.bias.float() - mean * scale
    return (x32 * scale + shift).to(x.dtype)


class _SumOverRanks(torch.autograd.Function):
    """A tensor summed over the ranks of a process group. Every rank's loss
    depends on the sum, so the backward sums the ranks' cotangents the same
    way."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _SumOverRanks.apply(g, ctx.group), None


def _global_moments(x32: torch.Tensor, axes: tuple, group):
    """(mean, biased variance, count) per channel of the batch whose shards
    the ranks of `group` hold, by one differentiable all-reduce of the
    shards' sums, sums of squares and counts."""
    c = x32.shape[-1]
    local = torch.cat([x32.sum(axes), x32.square().sum(axes),
                       x32.new_full((1,), float(x32.numel() // c))])
    total = _SumOverRanks.apply(local, group)
    count = int(total[2 * c].item())
    mean = total[:c] / count
    return mean, total[c : 2 * c] / count - mean.square(), count


def conv2d_tf(w: torch.Tensor, x: torch.Tensor, *, stride_freq: int, pad_time: int):
    """2-D convolution over (batch, time, freq, C), no bias. `w` is the
    reference's (out, in, k_freq, k_time) weight; stride 1 over time (zero
    padded by `pad_time` on both sides) and `stride_freq` over frequency
    (no padding), as the reference's Conv2d(kernel=(freq_k, 3),
    stride=(freq_s, 1), padding=(0, 1))."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2),  # (batch, C, time, freq)
        w.permute(0, 1, 3, 2).to(x.dtype),  # (out, in, k_time, k_freq)
        stride=(1, stride_freq),
        padding=(pad_time, 0),
    )
    return y.permute(0, 2, 3, 1)
