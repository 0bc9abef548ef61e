#!/usr/bin/env python3
"""What the flash-attention forward's time goes to: the full kernel against
the same kernel with parts left out, at the frontend time-attention shape
(bh = 512, n = 1536, d = 32, bfloat16).

    python -m beat_this_tpu_torch.bench.flash_ablate [--device cuda]

Counterpart of tools/bench_flash_ablate.py. Modes:
  full      the forward of `ops/flash_attention.py` (rotation, scale, online
            softmax in base 2)
  norope    no rotation and no d^-0.5 log2(e) scale: exp2 of the raw scores
  noexp     p = s and l = sum(s): no maximum, no exp2 (wrong on purpose, the
            same products and casts)
  mxu_only  acc += round(s) v and l = the number of key blocks: the two
            products and nothing between them

`block_k` is part of each function's meaning where the tool's arithmetic
depends on it: `mxu_only` divides by ceil(n / block_k). The CUDA kernels
(on the tensor cores, float32 as split bfloat16 products) always walk
64-key tiles, so the tool's (block_q, block_k) sweep has no
counterpart here and is dropped; `--block-k` only sets that denominator.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from beat_this_tpu_torch.bench.timing import bench_device, device_line, median_ms
from beat_this_tpu_torch.model.layers import round_value, wide
from beat_this_tpu_torch.ops import _build
from beat_this_tpu_torch.ops.flash_attention import (
    LOG2E,
    REF_CHUNK_ELEMS,
    aligned,
    check_qkv,
    ptr,
    rotated,
    rotation_scratch,
    table,
)
from beat_this_tpu_torch.ops.fused_ff import stream_of

MODES = ("full", "norope", "noexp", "mxu_only")
BLOCK_K = 768  # the tool's key block (bench_flash_ablate.py:143)
HEAD_DIM = 32  # the tool's head width (bench_flash_ablate.py:141)


def _ref_chunk(q, k, v, cos, sin, mode, block_k):
    """tools/bench_flash_ablate.py:make_kernel on a few leading entries, key
    block by key block, with its rounding points: q and k rounded after the
    rotation (and q's scale), p rounded before the PV product."""
    dtype = q.dtype
    n, d = q.shape[1:]
    if mode == "norope":  # :33-34, :49-50
        qr, kr = wide(q), wide(k)
    else:  # :36-42, :52-55
        qr = rotated(q, cos, sin, d**-0.5 * LOG2E)
        kr = rotated(k, cos, sin)
    v32 = wide(v)
    m = torch.full((*q.shape[:2], 1), -torch.inf, dtype=qr.dtype, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qr)
    for k0 in range(0, n, block_k):
        s = torch.matmul(qr, kr[:, k0 : k0 + block_k].transpose(-1, -2))  # :57-60
        vb = v32[:, k0 : k0 + block_k]
        if mode in ("full", "norope"):  # :61-71
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp2(s - m_new)
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.matmul(round_value(p, dtype), vb)
            m = m_new
        elif mode == "noexp":  # :72-81
            l = l + s.sum(-1, keepdim=True)
            acc = acc + torch.matmul(round_value(s, dtype), vb)
        else:  # mxu_only, :82-89
            acc = acc + torch.matmul(round_value(s, dtype), vb)
            l = l + 1.0
    return (acc / l).to(dtype), l[..., 0]  # :90


def flash_variant_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cos: Optional[torch.Tensor], sin: Optional[torch.Tensor], mode: str,
                      block_k: int = BLOCK_K, with_denominator: bool = False):
    """Plain PyTorch version of `flash_variant`. With `with_denominator`
    also the float32 denominators l (bh, n), which `noexp` divides by and
    which may lie near zero."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    bh, n, _ = q.shape
    step = max(1, REF_CHUNK_ELEMS // (n * min(n, block_k)))
    outs = [_ref_chunk(q[b : b + step], k[b : b + step], v[b : b + step], cos, sin, mode, block_k)
            for b in range(0, bh, step)]
    out = torch.cat([o for o, _ in outs])
    return (out, torch.cat([l for _, l in outs])) if with_denominator else out


def flash_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cos: Optional[torch.Tensor], sin: Optional[torch.Tensor], mode: str,
                  block_k: int = BLOCK_K, with_denominator: bool = False):
    """The flash forward over q, k, v (bh, n, head_dim) in `mode` (one of
    MODES), with half-width rotation tables (n, head_dim // 2) or None.
    CUDA tensors launch `csrc/flash_attention.cu` (head_dim 16 or 32,
    float32 or bfloat16) or raise; CPU tensors run the plain version. With
    `with_denominator` (mode "noexp") also returns l (bh, n) float32."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if q.device.type == "cpu":
        return flash_variant_ref(q, k, v, cos, sin, mode, block_k, with_denominator)
    if with_denominator and mode != "noexp":
        raise ValueError("only mode 'noexp' has a denominator output")
    q, k, v = aligned(q), aligned(k), aligned(v)
    bh, n, d = q.shape
    cos, sin = table(cos, n), table(sin, n)
    code = check_qkv("flash_variant", q, k, v, cos, sin)
    lib = _build.load_library()
    out = torch.empty_like(q)
    den = torch.empty((bh, n), dtype=torch.float32, device=q.device) if with_denominator else None
    scratch = rotation_scratch(q)
    with torch.cuda.device(q.device):
        _build.check(
            lib.bt_flash_ablate(
                code, d, MODES.index(mode), q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(cos),
                ptr(sin), out.data_ptr(), ptr(den), bh, n, float(-(-n // block_k)),
                ptr(scratch), stream_of(q),
            ),
            "bt_flash_ablate",
        )
    flash_variant.launches += 1
    return (out, den) if with_denominator else out


flash_variant.launches = 0


def make_inputs(bh: int, n: int, d: int, device: torch.device, dtype=torch.bfloat16):
    """The tool's inputs (bench_flash_ablate.py:97-98, :116-117): q, k, v
    from RandomState(0), rotation tables of ones and zeros."""
    rng = np.random.RandomState(0)
    qkv = torch.from_numpy(rng.randn(3, bh, n, d).astype(np.float32)).to(device).to(dtype)
    cos = torch.ones((n, d // 2), dtype=torch.float32, device=device)
    sin = torch.zeros((n, d // 2), dtype=torch.float32, device=device)
    return qkv[0], qkv[1], qkv[2], cos, sin


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bh", type=int, default=512, help="leading entries [%(default)s]")
    parser.add_argument("--seq", type=int, default=1536, help="sequence length [%(default)s]")
    parser.add_argument("--block-k", type=int, default=BLOCK_K,
                        help="key block of the tool's arithmetic: mxu_only divides by "
                             "ceil(seq / block_k) [%(default)s]")
    parser.add_argument("--modes", default=",".join(MODES))
    parser.add_argument("--reps", type=int, default=10, help="timed windows [%(default)s]")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    device = bench_device(args.device)
    print(device_line(device))
    q, k, v, cos, sin = make_inputs(args.bh, args.seq, HEAD_DIM, device)
    flops = args.bh * 4 * args.seq * args.seq * HEAD_DIM
    results = {}
    with torch.inference_mode():
        for mode in args.modes.split(","):
            ms = median_ms(lambda: flash_variant(q, k, v, cos, sin, mode, args.block_k), device,
                           args.reps)
            results[mode] = ms
            print(f"{mode:10s} bk={args.block_k:5d}  {ms:8.3f} ms  {flops / ms / 1e9:6.2f} TF/s")
    return results


if __name__ == "__main__":
    main()
