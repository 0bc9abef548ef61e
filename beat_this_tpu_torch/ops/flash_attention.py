"""Softmax attention over (bh, n, head_dim) with the rotation of q and k
inside: `softmax(rope(q) rope(k)^T head_dim^-0.5) v` per leading entry.

Counterpart of beat_this_tpu/ops/flash_attention.py:flash_attention, which
`attention_block` takes for unmasked sequences of at least FLASH_MIN_SEQ
frames when the fused time kernels decline the shape (a head width other
than 32). On a CUDA tensor `flash_attention` launches the hand-written
kernels in `csrc/flash_attention.cu` (a softmax in base 2, never an (n, n)
tensor in device memory; every product on the tensor cores, float32 as
split bfloat16 products, each query's maximum score taken in a first walk
over the keys, after a pre-pass that writes the rotated q and k, and in
float32 also v and the cotangent, as bfloat16 parts to scratch this module
allocates); on a CPU tensor it runs the plain version
`flash_attention_ref`. It is differentiable: the forward saves q, k, v, o
and the base-2 log-sum-exp per query, the backward is a query-major dq
kernel and a key-major dk/dv kernel.

Dropout at `dropout_rate` acts on the probabilities, from a Philox `seed`
(`ops/dropout.py`) under SALT_ATTN at SITE_ATTN_PROBS with the coordinates
(item0 + bh // heads, bh % heads, query, key): pass `heads` for the masks
of `attention_block`'s (batch, heads, n, n) layout, and `item0` for the
first item of a shard of the global batch. The kept probability
multiplies the unnormalized p while the normalizer sums the undropped p.

In bfloat16 the plain version rounds where the kernels round: q after the
rotation and the folded factor head_dim^-0.5 log2(e), k after the
rotation, the dropped p before the PV product, the output once; in the
backward the cotangent of the scores before the dq and dk products.
"""

from __future__ import annotations

from typing import Optional

import torch

from beat_this_tpu_torch.model.layers import recomputed, round_grad, round_value, wide
from beat_this_tpu_torch.ops import _build
from beat_this_tpu_torch.ops import dropout as drop
from beat_this_tpu_torch.ops.fused_ff import dtype_code, stream_of
from beat_this_tpu_torch.ops.rotary import apply_rope
from beat_this_tpu_torch.profiler import op_entry

SUPPORTED_HEAD_DIMS = (16, 32)
LOG2E = 1.4426950408889634
# score elements per chunk of `flash_attention_ref`: bounds its (chunk, n, n)
# float32 temporaries (a handful of them, half a GB each)
REF_CHUNK_ELEMS = 1 << 27


def rotated(x: torch.Tensor, cos: Optional[torch.Tensor], sin: Optional[torch.Tensor],
            mul: float = 1.0) -> torch.Tensor:
    """`x` (entries, seq, head_dim) rotated in float32 (float64 stays), times
    `mul`, rounded to the dtype of `x` and kept wide: an operand of a kernel's
    score product."""
    x32 = wide(x)
    if cos is not None:
        x32 = apply_rope(x32, cos[: x.shape[1]], sin[: x.shape[1]])
    return round_value(x32 * mul if mul != 1.0 else x32, x.dtype)


def probs_keep(seed: int, first: int, count: int, heads: int, rows: int, cols: int,
               rate: float, device) -> torch.Tensor:
    """(count, rows, cols) keep factors of the probabilities of the leading
    entries first .. first + count - 1, entry e at (e // heads, e % heads)."""
    entries = torch.arange(first, first + count, device=device, dtype=torch.int64)
    return drop.keep_mask_entries(seed, drop.SALT_ATTN, drop.SITE_ATTN_PROBS, entries // heads,
                                  entries % heads, rows, cols, rate)


def _ref_chunk(q, k, v, cos, sin, rate, seed, heads, first):
    dtype = q.dtype
    qr = rotated(q, cos, sin, q.shape[-1] ** -0.5 * LOG2E)
    kr = rotated(k, cos, sin)
    s = round_grad(torch.matmul(qr, kr.transpose(-1, -2)), dtype)
    p = torch.exp2(s - s.amax(-1, keepdim=True).detach())
    norm = p.sum(-1, keepdim=True)
    if rate > 0.0 and seed is not None:
        with torch.no_grad():
            keep = probs_keep(seed, first, len(q), heads, q.shape[1], k.shape[1], rate, q.device)
        p = p * keep.to(p.dtype)
    return (torch.matmul(round_value(p, dtype), wide(v)) / norm).to(dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rope_cos: Optional[torch.Tensor] = None,
                        rope_sin: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
                        seed: Optional[int] = None, heads: int = 1,
                        item0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of `flash_attention`, step by step with the
    kernels' rounding points, differentiable by autograd. Leading entries go
    in chunks of at most REF_CHUNK_ELEMS scores, and under autograd each
    chunk is recomputed in the backward (`recomputed`), so no (n, n) tensor
    outlives its chunk's pass."""
    bh, n, _ = q.shape
    step = max(1, REF_CHUNK_ELEMS // (n * k.shape[1]))
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for b0 in range(0, bh, step):
        args = (q[b0 : b0 + step], k[b0 : b0 + step], v[b0 : b0 + step], rope_cos, rope_sin,
                dropout_rate, seed, heads, item0 * heads + b0)
        outs.append(recomputed(_ref_chunk, *args) if grad else _ref_chunk(*args))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos, sin) -> int:
    """Raise unless q, k, v are CUDA tensors of one shape (entries, seq, D)
    and dtype with D in SUPPORTED_HEAD_DIMS and the tables fit; returns the
    dtype code."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {q.device}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name} takes q, k, v of one shape (entries, seq, head_dim), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name} kernel supports head_dim in {SUPPORTED_HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    if (cos is None) != (sin is None):
        raise ValueError(f"{name} takes both rotation tables or neither")
    if cos is not None and (cos.shape != (q.shape[1], q.shape[-1] // 2) or sin.shape != cos.shape):
        raise ValueError(f"{name} takes rotation tables of shape (seq, head_dim // 2), got "
                         f"{tuple(cos.shape)}, {tuple(sin.shape)}")
    return dtype_code(q.dtype)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous at a 16-byte aligned address, as the kernels' row loads
    need (a view into a larger tensor may start anywhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def table(t: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """The first `n` rows of a rotation table as the kernels read it."""
    return None if t is None else t[:n].detach().float().contiguous()


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# bfloat16 parts of a float32 operand in the kernels' forward (its 1e-5
# limits need float32's own precision) and backward (about 16 bits hold
# its 1e-4): tests/test_torch_flash_f32_design.py
FWD_PARTS, BWD_PARTS = 3, 2


def rotation_scratch(q: torch.Tensor, backward: bool = False) -> torch.Tensor:
    """The pre-pass's bfloat16 scratch, (planes, *q.shape): in bfloat16 the
    rotated q and k (2 planes; v and the cotangent are read in place); in
    float32 the rotated q, k and v, and in the backward the cotangent, each
    as FWD_PARTS (forward: 9 planes) or BWD_PARTS (backward: 8) parts."""
    if q.dtype == torch.bfloat16:
        planes = 2
    else:
        planes = 4 * BWD_PARTS if backward else 3 * FWD_PARTS
    return torch.empty((planes, *q.shape), dtype=torch.bfloat16, device=q.device)


def _launch_fwd(q, k, v, cos, sin, rate, seed, heads, lse, item0):
    code = check_qkv("flash_attention", q, k, v, cos, sin)
    bh, n, d = q.shape
    lib = _build.load_library()
    out = torch.empty_like(q)
    scratch = rotation_scratch(q)
    with torch.cuda.device(q.device):
        _build.check(
            lib.bt_flash_fwd(
                code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(cos), ptr(sin),
                out.data_ptr(), ptr(lse), bh, n, heads,
                *drop.kernel_args(rate, seed, drop.SALT_ATTN), *drop.base_args(item0, 0),
                ptr(scratch), stream_of(q),
            ),
            "bt_flash_fwd",
        )
    return out


@op_entry
def flash_fwd(q, k, v, cos, sin, rate, seed, heads, item0: int = 0) -> torch.Tensor:
    """Launch the forward without the log-sum-exp output (no backward will
    follow); returns o."""
    out = _launch_fwd(q, k, v, cos, sin, rate, seed, heads, None, item0)
    flash_fwd.launches += 1
    return out


@op_entry
def flash_fwd_lse(q, k, v, cos, sin, rate, seed, heads, item0: int = 0):
    """Launch the forward that also writes the base-2 log-sum-exp per query;
    returns (o, lse)."""
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    out = _launch_fwd(q, k, v, cos, sin, rate, seed, heads, lse, item0)
    flash_fwd_lse.launches += 1
    return out, lse


@op_entry
def flash_bwd(q, k, v, cos, sin, out, lse, dout, rate, seed, heads, item0: int = 0):
    """Launch the backward (the dq kernel, then the dk/dv kernel); returns
    (dq, dk, dv). delta = rowsum(dout * o) is computed here, in float32."""
    code = check_qkv("flash_attention", q, k, v, cos, sin)
    bh, n, d = q.shape
    lib = _build.load_library()
    delta = (dout.float() * out.float()).sum(-1)
    dout = aligned(dout.to(q.dtype))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    scratch = rotation_scratch(q, backward=True)
    with torch.cuda.device(q.device):
        _build.check(
            lib.bt_flash_bwd(
                code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(cos), ptr(sin),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), bh, n, heads, *drop.kernel_args(rate, seed, drop.SALT_ATTN),
                *drop.base_args(item0, 0), ptr(scratch), stream_of(q),
            ),
            "bt_flash_bwd",
        )
    flash_bwd.launches += 1
    return dq, dk, dv


flash_fwd.launches = 0
flash_fwd_lse.launches = 0
flash_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """q, k, v (bh, n, D) -> o; saves q, k, v, o and lse (O(n D) each, never
    the rotated copies or an (n, n) tensor); the backward regenerates the
    dropout mask from `seed`."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, rate, seed, heads, item0):
        ctx.rate, ctx.seed, ctx.heads, ctx.item0 = rate, seed, heads, item0
        if not any(ctx.needs_input_grad[:3]):
            return flash_fwd(q, k, v, cos, sin, rate, seed, heads, item0)
        out, lse = flash_fwd_lse(q, k, v, cos, sin, rate, seed, heads, item0)
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, cos, sin, out, lse, dout, ctx.rate, ctx.seed, ctx.heads,
                               ctx.item0)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rope_cos: Optional[torch.Tensor] = None,
                    rope_sin: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
                    seed: Optional[int] = None, heads: int = 1,
                    item0: int = 0) -> torch.Tensor:
    """Differentiable attention over q, k, v (bh, n, head_dim) with scale
    head_dim^-0.5, optional half-width rotation tables (n, head_dim // 2)
    applied to q and k inside, and dropout on the probabilities at
    `dropout_rate` from the int `seed` (off when None), entry e drawing the
    mask of (item0 + e // heads, e % heads). CUDA tensors run the kernels (head_dim
    in SUPPORTED_HEAD_DIMS, float32 or bfloat16, any n) or raise; CPU tensors
    the plain version."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, rope_cos, rope_sin, dropout_rate, seed, heads,
                                   item0)
    n = q.shape[1]
    return _FlashAttention.apply(aligned(q), aligned(k), aligned(v), table(rope_cos, n),
                                 table(rope_sin, n), float(dropout_rate), seed, int(heads),
                                 int(item0))
