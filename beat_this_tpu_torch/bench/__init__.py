"""Ablation benches of the port's kernels: what each stage of a fused block,
each part of the flash forward and each softmax pass costs on the card.

Counterparts of tools/bench_fused_freq_ablate.py, tools/bench_flash_ablate.py
and tools/bench_softmax_variants.py, as entry points of the port:

    python -m beat_this_tpu_torch.bench.fused_freq_ablate
    python -m beat_this_tpu_torch.bench.flash_ablate
    python -m beat_this_tpu_torch.bench.softmax_variants

Each runs on the card unless `--device cpu` is given, where the plain
versions run (small sizes only). Every variant is a hand-written CUDA kernel
under `csrc/` with a plain PyTorch version (`*_ref`) beside its wrapper.
"""
