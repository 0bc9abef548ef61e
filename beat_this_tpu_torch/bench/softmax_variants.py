#!/usr/bin/env python3
"""What the softmax passes cost inside the time-attention kernels, two ways.

    python -m beat_this_tpu_torch.bench.softmax_variants [--reps 4] [--device cuda]

Counterpart of tools/bench_softmax_variants.py:

1. In-situ pass costs: an attention forward at the model's two geometries
   (a main layer: 32 items of 4 heads; frontend block 0: 512 items of 1
   head; n = 1536 with keys >= 1500 masked, bfloat16) in variants that drop
   or change one pass at a time (`attention_variant`, VARIANTS). The
   differences between variants are the passes' marginal costs.
2. Standalone pass kernels: just exp2, just a row maximum, just a row sum
   over a (36864, 1536) float32 array from device memory (`softmax_pass`).

Variants: nosmax nomax noexp b16exp full kfold b16s b16sfold (eval-shaped)
and tfull tmxusum tb16sum (a separate row sum, as training needs it); the
arithmetic of each is in `attention_variant_ref`. On the card they run on
the tile of the tensor-core attention kernels (`csrc/softmax_variants.cu`
on `csrc/attn_tc.cuh`, every product on `mma.sync`), so their differences
are what the passes cost beside products on the tensor cores. The tool folds the mask
into the score product for b16s as well as b16sfold, so the two are one
function. The tool's `--scan` (copies scanned per dispatch) is dropped: each
timed window is one launch.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from beat_this_tpu_torch.bench.timing import bench_device, device_line, median_ms
from beat_this_tpu_torch.model.layers import HEAD_DIM, round_value, wide
from beat_this_tpu_torch.ops import _build
from beat_this_tpu_torch.ops.fused_ff import dtype_code, stream_of

# the C entry points' variant and op codes
VARIANTS = ("nosmax", "nomax", "noexp", "b16exp", "full", "kfold", "b16s", "b16sfold",
            "tfull", "tmxusum", "tb16sum")
FOLDED = ("kfold", "b16s", "b16sfold")
PASSES = ("exp2", "rowmax", "rowsum")
N_PAD, N_VALID = 1536, 1500
# (name, items, heads per item) of the tool's two geometries (:211-214)
GEOMETRIES = (("main-layer (32 prog x 4 heads)", 32, 4), ("front C=32 (512 prog x 1 head)", 512, 1))
PASS_ROWS, PASS_OUT_COLS = 24 * N_PAD, 128
REF_CHUNK_ELEMS = 1 << 27  # score elements per chunk of `attention_variant_ref`


def _ref_chunk(q, k, v, mask, mask_col, variant, heads):
    """tools/bench_softmax_variants.py:attn_kernel (:74-148) over a few
    items, all heads at once."""
    dtype = q.dtype
    items, n, _ = q.shape

    def split(t):  # (items, n, heads * 32) -> (items, heads, n, 32), float32
        return wide(t).reshape(items, n, heads, HEAD_DIM).transpose(1, 2)

    def rnd(t):
        return round_value(t, dtype)

    q32, k32, v32 = split(q), split(k), split(v)
    s = torch.matmul(q32, k32.transpose(-1, -2))
    if variant in FOLDED:  # :85-89: the mask rides the contraction as its last term
        s = s + rnd(mask_col.float())
    else:  # :99-100
        s = s + mask.float()
    if variant in ("b16s", "b16sfold"):  # :90-93, :101-105
        s = rnd(s)
    l = None
    if variant == "nosmax":  # :109-110
        p = rnd(s)
    elif variant == "nomax":  # :111-112
        p = rnd(torch.exp2(s))
    elif variant == "noexp":  # :113-115
        p = rnd(s - s.amax(-1, keepdim=True))
    elif variant == "b16exp":  # :116-118
        p = rnd(torch.exp2(rnd(s - s.amax(-1, keepdim=True))))
    else:  # :106-108, :119-136
        p32 = torch.exp2(s - s.amax(-1, keepdim=True))
        p = rnd(p32)
        if variant == "tfull":
            l = p32.sum(-1, keepdim=True)
        elif variant == "tb16sum":
            l = p.sum(-1, keepdim=True)
        elif variant == "tmxusum":
            l = torch.matmul(p, torch.ones((n, 1), dtype=p.dtype, device=p.device))
    ones = torch.ones((items, heads, n, 1), dtype=v32.dtype, device=v32.device)
    o_full = torch.matmul(p, torch.cat([v32, ones], -1))  # :137-141
    o = o_full[..., :HEAD_DIM] / (l if l is not None else o_full[..., HEAD_DIM:])  # :142-146
    return o.to(dtype).transpose(1, 2).reshape(items, n, heads * HEAD_DIM)


def attention_variant_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                          variant: str, heads: int,
                          mask_col: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of `attention_variant`, each variant with its
    own rounding points; items go in chunks so that the (n, n) scores stay
    bounded."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    mask_col = mask if mask_col is None else mask_col
    items, n, _ = q.shape
    step = max(1, REF_CHUNK_ELEMS // (heads * n * n))
    return torch.cat([
        _ref_chunk(q[i : i + step], k[i : i + step], v[i : i + step], mask, mask_col, variant,
                   heads)
        for i in range(0, items, step)
    ])


def attention_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                      variant: str, heads: int,
                      mask_col: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over q (pre-scaled), k, v (items, n, heads * 32) with the
    additive key mask `mask` (n,) float32 and the softmax pass `variant`
    (one of VARIANTS). The folded variants take the mask from `mask_col`
    (n,), rounded to the dtype (default: `mask`). CUDA tensors launch
    `csrc/softmax_variants.cu` (float32 or bfloat16: every product on the
    tensor cores, float32 as split bf16 products) or raise; CPU tensors run
    the plain version."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if q.device.type == "cpu":
        return attention_variant_ref(q, k, v, mask, variant, heads, mask_col)
    if q.device.type != "cuda":
        raise ValueError(f"attention_variant runs on CUDA or CPU tensors, got {q.device}")
    items, n, width = q.shape
    if width != heads * HEAD_DIM or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention_variant takes q, k, v of one shape (items, n, heads * "
                         f"{HEAD_DIM}), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention_variant takes q, k, v of one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    row = mask_col if variant in FOLDED and mask_col is not None else mask
    row = row.detach().float().reshape(-1).contiguous()
    if row.shape[0] != n or row.device != q.device:
        raise ValueError(f"attention_variant takes a mask of {n} keys on {q.device}")
    code = dtype_code(q.dtype)
    lib = _build.load_library()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.check(
            lib.bt_attn_variant(code, VARIANTS.index(variant), q.data_ptr(), k.data_ptr(),
                                v.data_ptr(), row.data_ptr(), out.data_ptr(), items, n, heads,
                                stream_of(q)),
            "bt_attn_variant",
        )
    attention_variant.launches += 1
    return out


attention_variant.launches = 0


def softmax_pass_ref(x: torch.Tensor, op: str, out_cols: int) -> torch.Tensor:
    """Plain PyTorch version of `softmax_pass`
    (tools/bench_softmax_variants.py:kern, :177-188)."""
    if op == "exp2":
        return torch.exp2(x)[:, :out_cols].contiguous()
    if op == "rowmax":
        return x.amax(1, keepdim=True).expand(-1, out_cols).contiguous()
    if op == "rowsum":
        return x.sum(1, keepdim=True).expand(-1, out_cols).contiguous()
    raise ValueError(f"op must be one of {PASSES}, got {op!r}")


def softmax_pass(x: torch.Tensor, op: str, out_cols: int) -> torch.Tensor:
    """One pass `op` (one of PASSES) over x (rows, cols) float32 -> (rows,
    out_cols): the first columns of exp2(x), or the row maximum or row sum
    in every column. CUDA tensors launch `csrc/softmax_passes.cu` or raise;
    CPU tensors run the plain version."""
    if op not in PASSES:
        raise ValueError(f"op must be one of {PASSES}, got {op!r}")
    if x.device.type == "cpu":
        return softmax_pass_ref(x, op, out_cols)
    if x.device.type != "cuda":
        raise ValueError(f"softmax_pass runs on CUDA or CPU tensors, got {x.device}")
    if x.ndim != 2 or x.dtype != torch.float32 or not 1 <= out_cols <= x.shape[1]:
        raise ValueError("softmax_pass takes a float32 (rows, cols) tensor and 1 <= out_cols <= "
                         f"cols, got {x.dtype} {tuple(x.shape)}, out_cols {out_cols}")
    lib = _build.load_library()
    x = x.contiguous()
    out = torch.empty((x.shape[0], out_cols), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.check(
            lib.bt_softmax_pass(PASSES.index(op), x.data_ptr(), out.data_ptr(), x.shape[0],
                                x.shape[1], out_cols, stream_of(x)),
            "bt_softmax_pass",
        )
    softmax_pass.launches += 1
    return out


softmax_pass.launches = 0


def make_masks(n: int, n_valid: int, device: torch.device):
    """The tool's key masks (:224-225): -1e5 on the padded keys for the
    additive mask, -98304 (exact in bfloat16) for the folded column."""
    mask = torch.zeros(n, dtype=torch.float32, device=device)
    mask[n_valid:] = -1e5
    mask_col = torch.zeros(n, dtype=torch.float32, device=device)
    mask_col[n_valid:] = -98304.0
    return mask, mask_col


def make_qkv(rng: np.random.RandomState, items: int, n: int, heads: int, device: torch.device,
             dtype=torch.bfloat16):
    """q, k, v as the tool draws them (:218-223): randn * 0.3."""
    return tuple(
        torch.from_numpy((rng.randn(items, n, heads * HEAD_DIM) * 0.3).astype(np.float32))
        .to(device).to(dtype) for _ in range(3))


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=4, help="timed windows [%(default)s]")
    parser.add_argument("--seq", type=int, default=N_PAD, help="padded keys [%(default)s]")
    parser.add_argument("--valid", type=int, default=N_VALID, help="unmasked keys [%(default)s]")
    parser.add_argument("--items-scale", type=float, default=1.0,
                        help="scales the geometries' item counts and the standalone rows "
                             "(below 1 for a CPU run) [%(default)s]")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    device = bench_device(args.device)
    print(device_line(device))
    rng = np.random.RandomState(0)
    n = args.seq
    mask, mask_col = make_masks(n, args.valid, device)
    results = {}
    with torch.inference_mode():
        for name, items, gh in GEOMETRIES:
            items = max(1, round(items * args.items_scale))
            q, k, v = make_qkv(rng, items, n, gh, device)
            print(f"\n=== {name}: {items} programs, {gh} heads each ===")
            for var in VARIANTS:
                ms = median_ms(lambda: attention_variant(q, k, v, mask, var, gh, mask_col), device,
                               args.reps)
                results[(name, var)] = ms
                print(f"  {var:8s}: {ms:8.3f} ms")
            nel = items * gh * n * n / 1e6
            delta = results[(name, "full")] - results[(name, "nosmax")]
            print(f"  softmax in-situ: {delta:.3f} ms ({nel:.0f}M score els -> "
                  f"{nel / max(delta, 1e-9):.0f} Mel/ms)")
        rows = max(8, round(PASS_ROWS * args.items_scale))
        x = torch.from_numpy((rng.rand(rows, n) * 2 - 1).astype(np.float32)).to(device)
        nel = rows * n / 1e6
        print(f"\n=== standalone passes over ({rows}, {n}) f32 ===")
        for op in PASSES:
            ms = median_ms(lambda: softmax_pass(x, op, min(PASS_OUT_COLS, n)), device, args.reps)
            results[("standalone", op)] = ms
            print(f"  {op:7s}: {ms:8.3f} ms ({nel / ms:.0f} Mel/ms)")
    print("\n=== floor analysis ===")
    for name, _, _ in GEOMETRIES:
        base, full, tfull = (results[(name, key)] for key in ("nosmax", "full", "tfull"))
        print(f"  {name}: whole softmax = {full - base:.3f} ms of {full:.3f} ms "
              f"({100 * (full - base) / full:.1f}% of the eval kernel)")
        print(f"  {name}: softmax+sum    = {tfull - base:.3f} ms of {tfull:.3f} ms "
              f"({100 * (tfull - base) / tfull:.1f}% of the train kernel)")
    return results


if __name__ == "__main__":
    main()
