"""Where the time of one eval forward goes on the card:

    python -m beat_this_tpu_torch.bench.profile_eval [--precision float32|bfloat16]
        [--head-dim 32|16]

The full-width model (`init_beat_this(0)`, random weights from the seed)
predicts three click pieces made by `data.synth.click_track` from seed 0
through the chunked predictor, each once to warm up and then once under
`torch.profiler`: a 75 s piece (3750 frames, three 1500-frame chunks in one
forward: the unmasked path), a 12 s piece (601 frames in a 768-frame bucket:
the masked short-piece path) and a batch of 16 chunks of 1500 frames in one
forward (`inference.CHUNK_BATCH`: a long piece or a directory batch). For
each window it prints, beside the card's `nvidia-smi` name and power limit,
the wall time (host clock around a synchronized forward), the device's
summed kernel time and busy share (kernel time over wall), the device time
of each kernel entry's `bt.<entry>` range (`profiler.range_device_ms`: K2
`fused_time.cu`, K1 `fused_ff.cu`, K3 `fused_freq.cu`, at `--head-dim 16`
B10 `flash_attention.cu` and B12 `small_attention.cu`) and of the rest
(cuBLAS, cuDNN, mel, elementwise, copies), the kernels by family, and the
largest kernels. K1 and K2's tail run the same feed-forward kernels: the
range a kernel was launched in says whose it is. Needs a CUDA device: the
kernels run only there.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

from beat_this_tpu_torch import profiler

TOP = 10  # kernels listed by name per window

# kernel-name fragments -> family, first match wins; the SIMT kernels of
# earlier versions of K1, K2 and K3 are named too, so that one profile reads
# either tree
FAMILIES = (
    ("time_rows_kernel", "K2 rows (norm, gates)"),
    ("time_qkv_kernel", "K2 qkv (RoPE epilogue)"),
    ("attn_fwd_kernel", "K2 attention core"),
    ("time_out_kernel", "K2 out projection (y1)"),
    ("time_attn_kernel", "K2 attention (SIMT)"),
    ("time_out_ff_kernel", "K2 out projection + feed-forward (SIMT)"),
    ("fused_ff_kernel", "K1 (SIMT)"),
    ("operands_kernel", "FF weight operands"),
    ("ff_pre_kernel", "FF row pass"),
    ("ff_hidden_kernel", "FF hidden product"),
    ("ff_out_kernel", "FF output product"),
    ("ff_product_kernel", "FF output product, depth slices"),
    ("ff_out_sum_kernel", "FF output slices' sum"),
    ("freq_block_kernel", "K3 fused_freq (tensor cores)"),
    ("fused_freq_kernel", "K3 fused_freq"),
    ("rotate_kernel", "B10 pre-pass (rotation, operand parts)"),
    ("flash_fwd", "B10 flash_fwd"),
    ("small_fwd", "B12 small_fwd"),
)
OTHER = "other (cuBLAS, cuDNN, mel, elementwise, copies)"


def family(name: str) -> str:
    for frag, fam in FAMILIES:
        if frag in name:
            return fam
    return OTHER


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.bench.profile_eval")
    p.add_argument("--precision", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--head-dim", type=int, default=32, choices=[16, 32])
    return p


def main(argv=None) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from beat_this_tpu_torch.data.synth import click_track
    from beat_this_tpu_torch.inference import CHUNK_BATCH, ChunkedPredictor
    from beat_this_tpu_torch.bench.timing import nvidia_smi_line, seed_model
    from beat_this_tpu_torch.model.beat_this import BeatThisConfig

    args = get_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    dev = torch.device("cuda")
    cfg = BeatThisConfig(head_dim=args.head_dim)
    model = seed_model(cfg, dev).eval().requires_grad_(False)
    dtype = torch.bfloat16 if args.precision == "bfloat16" else torch.float32
    predictor = ChunkedPredictor(model, compute_dtype=dtype)

    rng = np.random.default_rng(0)

    def piece(frames: int) -> np.ndarray:
        return click_track(frames, 25, 3, 4, rng)[0].astype(np.float32)

    chunks = np.stack([piece(predictor.chunk_size) for _ in range(CHUNK_BATCH)])
    windows = (
        ("75 s piece (3 chunks)", lambda s=piece(3750): predictor.predict(s)),
        ("12 s piece (601 frames, masked)", lambda s=piece(601): predictor.predict(s)),
        (f"batch of {CHUNK_BATCH} chunks", lambda: predictor._forward(chunks)),
    )
    config = "stock" if args.head_dim == 32 else f"head_dim {args.head_dim}"
    print(f"[profile_eval] {smi}")
    results = {}
    for name, fn in windows:
        fn()  # warm: kernel build and caches
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name: dict[str, float] = defaultdict(float)
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
                by_name[evt.name] += evt.device_time_total / 1e3  # us -> ms
        by_family: dict[str, float] = defaultdict(float)
        for kname, ms in by_name.items():
            by_family[family(kname)] += ms
        device_ms = sum(by_name.values())
        ranges = profiler.range_device_ms(prof.events(), device_ms)
        print(f"[profile_eval] one forward, {name}, {config}, {args.precision}: wall "
              f"{1e3 * wall:.2f} ms, device kernel time {device_ms:.2f} ms, busy share "
              f"{device_ms / (1e3 * wall):.3f}")
        for entry, ms in sorted(ranges.items(), key=lambda kv: -kv[1]):
            print(f"[profile_eval]   {entry}: {ms:.2f} ms ({ms / device_ms:.1%})")
        for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
            print(f"[profile_eval]     {fam}: {ms:.2f} ms")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]:
            print(f"[profile_eval]     kernel {kname[:90]}: {ms:.3f} ms")
        results[name] = {"wall_ms": 1e3 * wall, "device_ms": device_ms,
                         "ranges": ranges, "families": dict(by_family)}
    return results


if __name__ == "__main__":
    main()
