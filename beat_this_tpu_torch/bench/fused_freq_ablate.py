#!/usr/bin/env python3
"""Which stage of the fused frequency-axis block its time goes to: the eval
kernel of `ops/fused_freq.py` cut off after each stage, at the frontend's
three shapes (C, F) = (32, 32), (64, 16), (128, 8), bfloat16.

    python -m beat_this_tpu_torch.bench.fused_freq_ablate [--batch 16]
        [--stages copy,rms,qkv,ff,attn,full] [--reps N] [--device cuda]

Counterpart of tools/bench_fused_freq_ablate.py. Each stage is the block's
own tensor-core kernel cut after it (`csrc/freq_block.cuh`, launched by
`csrc/freq_ablate.cu`): the same grid of 128-row tiles as `full` and its
blocks per SM (a cut whose fewer registers would let more blocks share an
SM takes more shared memory; `blocks_per_sm`), so attn + ff - copy stands
for `full`:
  copy   x -> out
  rms    RMSNorm only
  qkv    RMSNorm + the q/k/v projection (q's columns out)
  ff     RMSNorm + feed-forward residual, no attention
  attn   RMSNorm, q/k/v, RoPE, attention within each item, gates, out
         projection, residual
  full   the real kernel (`fused_freq_roformer`'s launch, bit for bit)

The tool's `--block` (rows per TPU grid step) has no counterpart: the CUDA
kernels' row tiles are compile-time constants, so the flag is dropped,
as is `--scan-len` (copies per TPU dispatch): each timed window is one launch.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from beat_this_tpu_torch.bench.timing import bench_device, device_line, median_ms
from beat_this_tpu_torch.model.layers import (
    HEAD_DIM,
    Attention,
    FeedForward,
    rms_norm,
    round_value,
    wide,
)
from beat_this_tpu_torch.ops import _build
from beat_this_tpu_torch.ops.flash_attention import LOG2E
from beat_this_tpu_torch.ops.fused_ff import dtype_code, f32, stream_of
from beat_this_tpu_torch.ops.fused_freq import _check_freq
from beat_this_tpu_torch.ops.fused_time import block_params
from beat_this_tpu_torch.ops.rotary import apply_rope, rope_tables

STAGES = ("copy", "rms", "qkv", "ff", "attn", "full")  # the C entry point's stage codes
SHAPES = ((32, 32), (64, 16), (128, 8))  # (C, F) of the frontend's three blocks
FRAMES = 1500


def ablate_stage_ref(x: torch.Tensor, params, stage: str, rope_cos: torch.Tensor,
                     rope_sin: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `ablate_stage`, after
    tools/bench_fused_freq_ablate.py:make_kernel (:47-98) with its rounding
    points: the normed rows, q/k/v (and q, k after the rotation), the
    probabilities, the attention output, the gates and the hidden layer are
    rounded to the dtype of x before their products; sums are float32."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    attn, ff = params
    dtype = x.dtype
    items, f, c = x.shape
    heads = c // HEAD_DIM

    def weight(w):
        return round_value(wide(w), dtype)

    if stage == "copy":  # :54-56
        return x.clone()
    x32 = wide(x).reshape(items * f, c)
    g = round_value(rms_norm(x32, attn.norm.gamma), dtype)  # :57
    if stage == "rms":  # :58-60
        return g.to(dtype).reshape(x.shape)
    x2 = x32
    if stage != "ff":
        qkv = round_value(F.linear(g, weight(attn.to_qkv.weight)), dtype)  # :61, _qkv_of
    if stage == "qkv":  # :62-64
        return qkv[:, :c].to(dtype).reshape(x.shape)
    if stage in ("attn", "full"):  # :65-78
        q, k, v = qkv.reshape(items, f, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
        cos, sin = rope_cos[:f].float(), rope_sin[:f].float()
        q = round_value(apply_rope(q, cos, sin) * (HEAD_DIM**-0.5 * LOG2E), dtype)
        k = round_value(apply_rope(k, cos, sin), dtype)
        s = torch.matmul(q, k.transpose(-1, -2))
        e = torch.exp2(s - s.amax(-1, keepdim=True))
        o = torch.matmul(round_value(e, dtype), v) / e.sum(-1, keepdim=True)
        o = round_value(o, dtype).transpose(1, 2).reshape(items * f, c)
        sig = torch.sigmoid(F.linear(g, wide(attn.to_gates.weight)) + attn.to_gates.bias)
        gate = round_value(sig, dtype).repeat_interleave(HEAD_DIM, dim=1)
        x2 = x32 + F.linear(round_value(o * gate, dtype), weight(attn.to_out[0].weight))
    if stage == "attn":  # :81-83
        return x2.to(dtype).reshape(x.shape)
    norm, lin1, _, _, lin2, _ = ff.net  # :84-96
    g2 = round_value(rms_norm(x2, norm.gamma), dtype)
    h1 = F.gelu(F.linear(g2, weight(lin1.weight)) + lin1.bias)
    y = F.linear(round_value(h1, dtype), weight(lin2.weight)) + lin2.bias
    return (x2 + y).to(dtype).reshape(x.shape)


def ablate_stage(x: torch.Tensor, params, stage: str, rope_cos: torch.Tensor,
                 rope_sin: torch.Tensor) -> torch.Tensor:
    """The eval frequency block over x (items, F, C) cut off after `stage`
    (one of STAGES); params = (Attention, FeedForward) of C // 32 heads,
    rope tables (>= F, 16). CUDA tensors launch `csrc/freq_ablate.cu` (the
    block's kernel cut after the stage; F dividing 32, C in (32, 64, 128),
    float32 or bfloat16) or raise; CPU tensors run the plain version."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if x.device.type == "cpu":
        return ablate_stage_ref(x, params, stage, rope_cos, rope_sin)
    attn, ff = params
    code = _check_freq("ablate_stage", x)
    items, f, c = x.shape
    lib = _build.load_library()
    xc = x.contiguous()
    kp = block_params(attn, ff, x.dtype)
    cos, sin = f32(rope_cos[:f]), f32(rope_sin[:f])
    out = torch.empty_like(xc)
    with torch.cuda.device(x.device):
        _build.check(
            lib.bt_freq_ablate(
                code, c, STAGES.index(stage), xc.data_ptr(), *(p.data_ptr() for p in kp),
                cos.data_ptr(), sin.data_ptr(), out.data_ptr(), items * f, f,
                ff.net[1].out_features, stream_of(x),
            ),
            "bt_freq_ablate",
        )
    ablate_stage.launches += 1
    return out


ablate_stage.launches = 0


def blocks_per_sm(c: int, stage: str, dtype: torch.dtype) -> int:
    """The blocks of `ablate_stage`'s launch at C and dtype that one SM of
    the current card holds: each cut as many as `full`, where its registers
    let it."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    blocks = ctypes.c_int()
    _build.check(_build.load_library().bt_freq_ablate_blocks(
        dtype_code(dtype), c, STAGES.index(stage), ctypes.byref(blocks)), "bt_freq_ablate_blocks")
    return blocks.value


def make_case(rng: np.random.RandomState, c: int, f: int, items: int, device: torch.device,
              dtype=torch.bfloat16):
    """The tool's block for one shape (bench_fused_freq_ablate.py:111-124),
    drawn in its order from `rng`: weights at its scales, rounded to
    bfloat16 as it holds them, and x (items, F, C)."""
    heads = c // HEAD_DIM

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float()

    attn, ff = Attention(c, heads), FeedForward(c)
    norm, lin1, _, _, lin2, _ = ff.net
    with torch.no_grad():
        attn.norm.gamma.copy_(torch.from_numpy(rng.randn(c).astype(np.float32)))
        attn.to_qkv.weight.copy_(t(rng.randn(c, 3 * c) * 0.05).T)
        attn.to_gates.weight.copy_(t(rng.randn(c, heads) * 0.05).T)
        attn.to_gates.bias.copy_(torch.from_numpy(rng.randn(heads).astype(np.float32)))
        attn.to_out[0].weight.copy_(t(rng.randn(c, c) * 0.05).T)
        norm.gamma.copy_(torch.from_numpy(rng.randn(c).astype(np.float32)))
        lin1.weight.copy_(t(rng.randn(c, 4 * c) * 0.05).T)
        lin1.bias.copy_(torch.from_numpy(rng.randn(4 * c).astype(np.float32)))
        lin2.weight.copy_(t(rng.randn(4 * c, c) * 0.05).T)
        lin2.bias.copy_(torch.from_numpy(rng.randn(c).astype(np.float32)))
    x = torch.from_numpy((rng.randn(items, f, c) * 0.5).astype(np.float32))
    params = (attn.to(device).requires_grad_(False), ff.to(device).requires_grad_(False))
    return x.to(device).to(dtype), params, rope_tables(f, HEAD_DIM, device)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16, help="chunks per launch [%(default)s]")
    parser.add_argument("--frames", type=int, default=FRAMES,
                        help="frames per chunk: items = batch * frames [%(default)s]")
    parser.add_argument("--stages", default=",".join(STAGES))
    parser.add_argument("--reps", type=int, default=10, help="timed windows [%(default)s]")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    device = bench_device(args.device)
    print(device_line(device))
    rng = np.random.RandomState(0)
    results = {}
    with torch.inference_mode():
        for c, f in SHAPES:
            x, params, (cos, sin) = make_case(rng, c, f, args.batch * args.frames, device)
            for stage in args.stages.split(","):
                ms = median_ms(lambda: ablate_stage(x, params, stage, cos, sin), device,
                               args.reps)
                results[(c, stage)] = ms
                print(f"C={c:4d} {stage:5s}: {ms:8.3f} ms/launch  {ms / args.batch:6.3f} ms/chunk")
    return results


if __name__ == "__main__":
    main()
