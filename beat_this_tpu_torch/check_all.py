"""The kernel gate of the port: every kernel check of tools/check_all_tpu.py
on the card, with a pass/fail JSON artifact.

    python -m beat_this_tpu_torch.check_all [--out GPUCHECK.json] [--only NAME ...]
                                            [--device cuda]

The same 12 checks under the same names and limits, "plain" being the
port's `kernels=False` path (the composable PyTorch versions the kernels
are held to):

  fused_time_parity             K2 against the plain block, heads 1 / 4 / 16
  fused_time_dropout_gradcheck  B4 / B5, heads 1 / 2 / 4 / 16, rate 0.1
  eval_logit_parity             the full-width model, kernel bf16 vs plain bf16
  flagship_train_steps          30 steps at 8 microbatches x 8 x 1500, bf16:
                                finite, falling; step time and peak memory
  beat_level_kernel_parity      the 16-piece suite through the minimal and the
                                DBN postprocessing, on the trained fixture
  train_grad_parity_no_dropout  2 layers, loss and every gradient
  train_dropout_finite          2 layers at the default dropout rates
  dropout_statistics            B10's kept mass and 1 / keep scaling
  flash_dropout_gradcheck       B10 / B11 with dropout
  small_attention_dropout_gradcheck  B12 with dropout
  fused_ff_dropout_gradcheck    B8 / B9 with dropout
  fused_freq_dropout_gradcheck  B6 / B7 at the second frontend block

The gradchecks compare a central difference along the analytic gradient
with the gradient's norm: the same seed must give the same dropout mask in
the forward without saved state, the forward that saves for the backward,
and the backward. The beat-level check trains the fixture (`_flagship_trained`)
first. On the CPU (`--device cpu`) every wrapper runs its plain version, so
kernel and plain agree by construction: that run checks the plumbing.
`main(argv, geometry)` takes a smaller `Geometry` for such runs; the command
line is at full width.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from beat_this_tpu_torch.bench.timing import nvidia_smi_line, seed_model
from beat_this_tpu_torch.model.beat_this import BeatThisConfig
from beat_this_tpu_torch.model.layers import Attention, FeedForward, freq_roformer, time_roformer
from beat_this_tpu_torch.ops.rotary import rope_tables


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Sizes of the checks; the defaults are tools/check_all_tpu.py's."""

    config: BeatThisConfig = BeatThisConfig()  # eval parity, fixture, freq gradcheck
    frames: int = 1500  # sequence length of the model inputs and time blocks
    time_cases: tuple = ((1, 4), (4, 2), (16, 2))  # (heads, items), fused_time_parity
    time_train_cases: tuple = ((1, 4), (2, 4), (4, 4), (16, 1))  # and its gradcheck
    micro: int = 8  # crops per microbatch of the fixture
    accum: int = 8  # microbatches per step of the fixture
    steps: int = 30  # fixture steps of flagship_train_steps and the beat-level check
    grad_layers: int = 2  # n_layers of the gradient checks
    stats: tuple = (4, 768, 32)  # dropout_statistics' q, k, v
    flash: tuple = (2, 640, 32)  # flash_dropout_gradcheck's q, k, v
    small: tuple = (256, 16, 32)  # small_attention_dropout_gradcheck's q, k, v
    ff: tuple = (640, 512, 2048)  # fused_ff_dropout_gradcheck: rows, C, hidden
    freq_items: int = 512  # fused_freq_dropout_gradcheck's items at F 16, C 64


FULL = Geometry()
GRAD_LIMIT = 8e-2  # the directional gradchecks' relative deviation
SUITE_FRAMES = 1500


def _logits(model, x: np.ndarray, kernels: bool, dtype, rows: int = 2):
    """(beat, downbeat) float32 logits of `x` in forwards of `rows` pieces."""
    dev = next(model.parameters()).device
    beats, downs = [], []
    with torch.inference_mode():
        for i in range(0, len(x), rows):
            out = model(torch.from_numpy(x[i : i + rows]).to(dev), compute_dtype=dtype,
                        kernels=kernels)
            beats.append(out["beat"].float().cpu().numpy())
            downs.append(out["downbeat"].float().cpu().numpy())
    return np.concatenate(beats), np.concatenate(downs)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _attention(rng: np.random.RandomState, gamma: np.ndarray, heads: int, device) -> Attention:
    """An attention module with norm gain `gamma` and the tool's random
    projections, drawn after it in its order (tools/check_all_tpu.py:509-515)."""
    c = len(gamma)
    draws = {"qkv_w": rng.randn(c, 3 * c) / np.sqrt(c),
             "gates_w": rng.randn(c, heads) / np.sqrt(c), "gates_b": rng.randn(heads) * 0.3,
             "out_w": rng.randn(c, c) / np.sqrt(c)}
    t = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in draws.items()}
    attn = Attention(c, heads)
    with torch.no_grad():
        attn.norm.gamma.copy_(torch.from_numpy(np.asarray(gamma, np.float32)))
        attn.to_qkv.weight.copy_(t["qkv_w"].T)
        attn.to_gates.weight.copy_(t["gates_w"].T)
        attn.to_gates.bias.copy_(t["gates_b"])
        attn.to_out[0].weight.copy_(t["out_w"].T)
    return attn.to(device).requires_grad_(False)


def _ff_module(draws: dict, device) -> FeedForward:
    """A FeedForward holding numpy parameters in the JAX layout (w1 (C, M))."""
    c = len(draws["norm_gamma"])
    ff = FeedForward(c)
    norm, lin1, _, _, lin2, _ = ff.net
    t = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in draws.items()}
    with torch.no_grad():
        norm.gamma.copy_(t["norm_gamma"])
        lin1.weight.copy_(t["w1"].T)
        lin1.bias.copy_(t["b1"])
        lin2.weight.copy_(t["w2"].T)
        lin2.bias.copy_(t["b2"])
    return ff.to(device).requires_grad_(False)


def _directional_gradcheck(loss_fn, x0: torch.Tensor):
    """Central difference of `loss_fn` at x0 along the analytic gradient g,
    against ||g||: (relative deviation, difference, analytic). Along g/||g||
    the derivative is largest, so the difference's error stays at the
    few-percent level (a random direction's derivative nearly cancels,
    tools/check_all_tpu.py:365-390). `loss_fn` must be deterministic (a
    fixed dropout seed)."""
    x = x0.detach().clone().requires_grad_(True)
    loss_fn(x).backward()
    g = x.grad.double()
    u = (g / g.norm()).to(x0.dtype)
    eps = 0.05 * float(x0.double().square().mean().sqrt())
    with torch.no_grad():
        lp = float(loss_fn(x0 + eps * u))
        lm = float(loss_fn(x0 - eps * u))
    fd = (lp - lm) / (2 * eps)
    an = float((g * u.double()).sum())  # == ||g||
    return abs(fd - an) / max(abs(an), 1e-9), fd, an


def _dot(out: torch.Tensor, cot: torch.Tensor) -> torch.Tensor:
    """<out, cot>, summed in float64."""
    return (out.double() * cot.double()).sum()


def _randn(rng: np.random.RandomState, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)


# -- the checks ---------------------------------------------------------------


def check_fused_time_parity(geo: Geometry, device):
    """K2 (`fused_time_roformer`) against the plain block at the model's
    eval geometries, bf16, including 16 heads."""
    rng = np.random.RandomState(11)
    worst = {}
    n = geo.frames
    for heads, items in geo.time_cases:
        c = heads * 32
        attn = _attention(rng, rng.randn(c) * 0.1 + 1, heads, device)
        ff = _ff_module({"norm_gamma": rng.randn(c) * 0.1 + 1,
                         "w1": rng.randn(c, 4 * c) / np.sqrt(c), "b1": rng.randn(4 * c) * 0.1,
                         "w2": rng.randn(4 * c, c) / np.sqrt(4 * c), "b2": rng.randn(c) * 0.1},
                        device)
        x = torch.from_numpy(rng.randn(items, n, c).astype(np.float32)).to(device, torch.bfloat16)
        rope = rope_tables(n, 32, device)
        with torch.inference_mode():
            want = time_roformer(attn, ff, x, rope, heads, kernels=False).float().cpu().numpy()
            got = time_roformer(attn, ff, x, rope, heads, kernels=True).float().cpu().numpy()
        rel = _rel(got, want)
        assert rel < 3e-2, f"heads={heads}: rel dev {rel:.3e}"
        worst[f"rel_h{heads}"] = rel
    return worst


def check_fused_time_dropout_gradcheck(geo: Geometry, device):
    """B4 / B5 (`fused_time_attention_train`) with dropout 0.1 at every head
    count the model routes to them."""
    from beat_this_tpu_torch.ops.fused_time import fused_time_attention_train

    out = {}
    n = geo.frames
    for heads, items in geo.time_train_cases:
        c = heads * 32
        rng = np.random.RandomState(40 + heads)
        attn = _attention(rng, rng.rand(c) + 0.5, heads, device)
        cos, sin = rope_tables(n, 32, device)
        x0 = _randn(rng, (items, n, c), device)
        cot = _randn(rng, (items, n, c), device)

        def loss(x):
            return _dot(fused_time_attention_train(x, attn, cos, sin, heads, 0.1, 23), cot)

        rel, _, _ = _directional_gradcheck(loss, x0)
        assert rel < GRAD_LIMIT, f"fused_time h={heads} dropout VJP: rel {rel:.3e}"
        out[f"rel_h{heads}"] = rel
    return out


def check_eval_logit_parity(geo: Geometry, device):
    """The full-width model's logits, kernels against plain, both bf16."""
    model = seed_model(geo.config, device).eval()
    x = np.random.RandomState(0).randn(2, geo.frames, 128).astype(np.float32)
    (ab, ad), (bb, bd) = (_logits(model, x, k, torch.bfloat16) for k in (True, False))
    rel_beat, rel_down = _rel(ab, bb), _rel(ad, bd)
    rel = max(rel_beat, rel_down)
    assert rel < 2.5e-2, f"eval logit deviation {rel:.3e}"
    return {"rel_dev": rel, "rel_dev_beat": rel_beat, "rel_dev_downbeat": rel_down}


def click_batch(accum: int, micro: int, t: int) -> dict:
    """tools/check_all_tpu.py:_flagship_trained's batch, bit for bit: noise
    with +6 bursts every 25 frames (120 bpm) from a random phase, every 4th
    burst +4 more on the lowest 32 bins (a downbeat's bass), as numpy."""
    rng = np.random.RandomState(5)
    spect = rng.randn(accum, micro, t, 128).astype(np.float32)
    truth_beat = np.zeros((accum, micro, t), np.float32)
    truth_down = np.zeros((accum, micro, t), np.float32)
    phase = rng.randint(0, 25, size=(accum, micro))
    for a in range(accum):
        for m in range(micro):
            beats = np.arange(phase[a, m], t, 25)
            spect[a, m, beats, :] += 6.0
            spect[a, m, beats[::4], :32] += 4.0
            truth_beat[a, m, beats] = 1.0
            truth_down[a, m, beats[::4]] = 1.0
    return {"spect": spect, "truth_beat": truth_beat, "truth_downbeat": truth_down,
            "padding_mask": np.ones((accum, micro, t), np.float32),
            "downbeat_mask": np.ones((accum, micro), np.float32)}


_FLAGSHIP: dict = {}


def _flagship_trained(geo: Geometry, device, steps: int = 30):
    """`steps` optimizer steps of the full-width model (`train/task.py`,
    TrainConfig(max_steps=max(100, steps), accum_steps=geo.accum), bf16, the
    shift-tolerant loss, the training kernels on the card) on `click_batch`,
    with the dropout seeds held fixed, so the loss (taken before each update)
    falls deterministically. Cached per (geometry, device, steps). Returns
    {"model": the trained model in eval mode, "curve": losses, "step_s":
    seconds per step, "peak_gib": peak device memory (None on the CPU)}."""
    from beat_this_tpu_torch.train.task import (
        TrainConfig,
        make_optimizer,
        make_scheduler,
        train_step,
    )

    key = (geo, str(device), steps)
    if key in _FLAGSHIP:
        return _FLAGSHIP[key]
    tc = TrainConfig(max_steps=max(100, steps), accum_steps=geo.accum,
                     compute_dtype="bfloat16")
    model = seed_model(geo.config, device)
    opt = make_optimizer(model, tc)
    sched = make_scheduler(opt, tc)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in click_batch(geo.accum, geo.micro, geo.frames).items()}
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    curve, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        parts = train_step(model, opt, sched, batch, torch.Generator().manual_seed(0), tc)
        curve.append(float(parts["total"]))  # waits for the step
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None
    _FLAGSHIP[key] = {"model": model.eval().requires_grad_(False), "curve": curve,
                      "step_s": step_s, "peak_gib": peak}
    return _FLAGSHIP[key]


def check_flagship_train_steps(geo: Geometry, device):
    """The fixture's loss: every step finite, the last below the first; its
    step time (the first step apart: it holds the build and cuDNN's choices)
    and peak memory at the reference's 8 microbatches."""
    run = _flagship_trained(geo, device, geo.steps)
    curve = run["curve"]
    assert all(np.isfinite(curve)), f"non-finite loss in {curve}"
    assert curve[-1] < curve[0], f"loss did not decrease: {curve}"
    warm = run["step_s"][1:] or run["step_s"]
    return {"steps": len(curve), "microbatches": geo.accum, "crops": geo.micro,
            "frames": geo.frames, "loss_first": curve[0], "loss_last": curve[-1],
            "step_s_first": run["step_s"][0], "step_s_median": float(np.median(warm)),
            "step_s_min": float(min(warm)), "peak_gib": run["peak_gib"],
            "curve": [round(v, 5) for v in curve]}


def _gate_suite():
    """tools/check_all_tpu.py:_gate_suite: 16 synthetic pieces over the
    DBN's 55-215 bpm range with varied burst strength, noise, adjacent
    double peaks and jitter, every 4th burst with a bass-band downbeat mark.
    Returns (spect (16, 1500, 128) float32, specs)."""
    specs = [
        (14, 6.0, 1.0, "plain"), (17, 6.0, 1.0, "plain"),
        (20, 6.0, 1.0, "plain"), (25, 6.0, 1.0, "plain"),
        (30, 6.0, 1.0, "plain"), (36, 6.0, 1.0, "plain"),
        (44, 6.0, 1.0, "plain"), (54, 6.0, 1.0, "plain"),
        (25, 4.0, 1.0, "weak"), (25, 6.0, 1.5, "noisy"),
        (20, 5.0, 1.2, "weak-noisy"), (25, 6.0, 1.0, "double"),
        (30, 6.0, 1.0, "double"), (25, 6.0, 1.0, "jitter"),
        (44, 4.5, 1.3, "sparse-weak"), (14, 6.0, 1.2, "dense-noisy"),
    ]
    rng = np.random.RandomState(3)
    t = SUITE_FRAMES
    spect = np.empty((len(specs), t, 128), np.float32)
    for i, (period, burst, noise, style) in enumerate(specs):
        spect[i] = rng.randn(t, 128) * noise
        frames = np.arange(3 + (i * 5) % period, t, period)
        if style == "jitter":
            frames = np.clip(frames + rng.randint(-1, 2, len(frames)), 0, t - 1)
        spect[i, frames, :] += burst
        spect[i, frames[::4], :32] += burst * 0.7
        if style == "double":  # adjacent peak pairs stress deduplication
            spect[i, np.minimum(frames + 1, t - 1), :] += burst * 0.9
    return spect, specs


def _gate_boundary(ref_logits, lo, hi):
    """tools/check_all_tpu.py:_gate_boundary: minus the midpoint of the
    widest gap among the reference path's sorted logits, over boundaries
    that keep between `lo` and `hi` frames above; added to both paths'
    logits it puts the decision threshold in the trained fixture's gap
    between peaks and background."""
    v = np.sort(np.asarray(ref_logits, np.float64).ravel())
    lo = max(2, int(lo))
    hi = min(len(v) - 1, max(int(hi), lo + 1))
    tail = v[len(v) - hi - 1 : len(v) - lo + 1]
    gaps = np.diff(tail)
    j = int(np.argmax(gaps))
    return -0.5 * (tail[j] + tail[j + 1])


def check_beat_level_kernel_parity(geo: Geometry, device):
    """Kernel against plain in postprocessed beat times: the suite's logits
    on the trained fixture through the minimal postprocessor (worst F of
    beats and downbeats per piece, >= 0.999), through the DBN decoder on the
    card (>= 0.999), and kernel bf16 against kernel f32 (>= 0.98). Each
    piece and channel is shifted by `_gate_boundary` of the plain path (the
    f32 kernel path for the precision leg)."""
    from beat_this_tpu_torch.metrics import f_measure
    from beat_this_tpu_torch.postprocessing import Postprocessor

    model = _flagship_trained(geo, device, geo.steps)["model"]
    spect, specs = _gate_suite()
    beat_k, down_k = _logits(model, spect, True, torch.bfloat16)
    beat_x, down_x = _logits(model, spect, False, torch.bfloat16)
    beat_f32, down_f32 = _logits(model, spect, True, torch.float32)

    post_min = Postprocessor("minimal", fps=50, device=device)
    post_dbn = Postprocessor("dbn", fps=50, device=device)
    out = {"n_pieces": len(specs)}
    worst_min = worst_dbn = worst_prec = 1.0
    t = SUITE_FRAMES
    sb_all, sd_all = [], []
    for i, (period, _, _, style) in enumerate(specs):
        n_expect = t // period
        sb = _gate_boundary(beat_x[i], n_expect // 2, n_expect * 3)
        sd = _gate_boundary(down_x[i], 2, n_expect * 3)
        sb_all.append(sb)
        sd_all.append(sd)
        bk, dk = post_min(beat_k[i] + sb, down_k[i] + sd)
        bx, dx = post_min(beat_x[i] + sb, down_x[i] + sd)
        assert len(bx) >= min(10, n_expect // 4), (
            f"degenerate fixture piece {i} ({style}): {len(bx)} plain-path peaks")
        f_beat = f_measure(bx, bk)
        f_down = f_measure(dx, dk) if len(dx) else 1.0
        worst_min = min(worst_min, f_beat, f_down)
        out[f"piece{i:02d}_f_min"] = round(min(f_beat, f_down), 4)

        sb32 = _gate_boundary(beat_f32[i], n_expect // 2, n_expect * 3)
        sd32 = _gate_boundary(down_f32[i], 2, n_expect * 3)
        b16, d16 = post_min(beat_k[i] + sb32, down_k[i] + sd32)
        b32, d32 = post_min(beat_f32[i] + sb32, down_f32[i] + sd32)
        fp_beat = f_measure(b32, b16)
        fp_down = f_measure(d32, d16) if len(d32) else 1.0
        worst_prec = min(worst_prec, fp_beat, fp_down)

    sb_all, sd_all = np.asarray(sb_all)[:, None], np.asarray(sd_all)[:, None]
    dbn_k = post_dbn(beat_k + sb_all, down_k + sd_all)
    dbn_x = post_dbn(beat_x + sb_all, down_x + sd_all)
    for i in range(len(specs)):
        bx, bk = np.asarray(dbn_x[0][i]), np.asarray(dbn_k[0][i])
        dx, dk = np.asarray(dbn_x[1][i]), np.asarray(dbn_k[1][i])
        f_beat = f_measure(bx, bk) if len(bx) else 1.0
        f_down = f_measure(dx, dk) if len(dx) else 1.0
        worst_dbn = min(worst_dbn, f_beat, f_down)
        out[f"piece{i:02d}_f_dbn"] = round(min(f_beat, f_down), 4)

    out["worst_f"] = worst_min
    out["worst_f_minimal"] = worst_min
    out["worst_f_dbn"] = worst_dbn
    out["worst_f_bf16_vs_f32"] = worst_prec
    assert worst_min >= 0.999, f"minimal-path agreement {worst_min:.4f}"
    assert worst_dbn >= 0.999, f"dbn-path agreement {worst_dbn:.4f}"
    assert worst_prec >= 0.98, f"bf16-vs-f32 agreement {worst_prec:.4f}"
    return out


def _train_grads(config, x: np.ndarray, seed: int, kernels: bool, device):
    """Loss mean(beat^2) + mean(downbeat^2) of one bf16 training forward of
    a fresh seed-0 model, and its gradients (float64, by parameter name)."""
    model = seed_model(config, device)
    out = model(torch.from_numpy(x).to(device), compute_dtype=torch.bfloat16, kernels=kernels,
                train=True, seed=seed)
    loss = out["beat"].square().mean() + out["downbeat"].square().mean()
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double().cpu()
             for n, p in model.named_parameters()}
    return float(loss.detach()), grads


def check_train_grad_parity_no_dropout(geo: Geometry, device):
    """Training gradients, kernels against plain, at dropout 0 (bf16)."""
    config = dataclasses.replace(geo.config, n_layers=geo.grad_layers, dropout_frontend=0.0,
                                 dropout_transformer=0.0)
    x = np.random.RandomState(0).randn(2, geo.frames, 128).astype(np.float32)
    v1, g1 = _train_grads(config, x, 7, True, device)
    v2, g2 = _train_grads(config, x, 7, False, device)
    rel = abs(v1 - v2) / max(abs(v2), 1e-9)
    assert rel < 2e-2, f"loss mismatch {rel:.3e}"
    scale = max(float(g.abs().max()) for g in g2.values())
    worst = max(float((g1[k] - g2[k]).abs().max()) for k in g2)
    assert worst < 2e-2 * scale, f"grad dev {worst:.3e} vs scale {scale:.3e}"
    return {"loss_rel": rel, "grad_dev": worst, "grad_scale": scale}


def check_train_dropout_finite(geo: Geometry, device):
    """Training loss and gradients finite at the default dropout rates."""
    config = dataclasses.replace(geo.config, n_layers=geo.grad_layers)
    x = np.random.RandomState(0).randn(2, geo.frames, 128).astype(np.float32)
    v, g = _train_grads(config, x, 3, True, device)
    assert np.isfinite(v), f"loss {v}"
    bad = [k for k, t in g.items() if not bool(torch.isfinite(t).all())]
    assert not bad, f"non-finite gradients: {bad}"
    return {"loss": v}


def check_dropout_statistics(geo: Geometry, device):
    """B10's in-kernel dropout: with v all ones each output element is the
    kept probability mass over keep, whose mean over many rows is 1 and
    whose spread is about sqrt(rate / (keep n)) (~0.018 at rate 0.2, n 768);
    two seeds give different masks."""
    from beat_this_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.RandomState(1)
    bh, n, d = geo.stats
    q, k = _randn(rng, (bh, n, d), device), _randn(rng, (bh, n, d), device)
    v = torch.ones(bh, n, d, device=device)
    with torch.inference_mode():
        outs = [flash_attention(q, k, v, dropout_rate=0.2, seed=s).double().cpu()
                for s in (11, 222)]
    assert not torch.allclose(outs[0], outs[1]), "seeds produce identical masks"
    for out in outs:
        mean, std = float(out.mean()), float(out.std())
        assert abs(mean - 1.0) < 0.02, f"dropout mean scaling off: {mean}"
        assert 0.005 < std < 0.1, (f"dropout spread {std} outside the expected band "
                                   "(0: mask inactive; large: scaling broken)")
    return {"mean": float(outs[0].mean()), "std": float(outs[0].std())}


def check_flash_dropout_gradcheck(geo: Geometry, device):
    """B10 / B11 (`flash_attention`) with dropout 0.2, along dq."""
    from beat_this_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.RandomState(2)
    k, v, cot, q0 = (_randn(rng, geo.flash, device) for _ in range(4))

    def loss(q):
        return _dot(flash_attention(q, k, v, dropout_rate=0.2, seed=17), cot)

    rel, fd, an = _directional_gradcheck(loss, q0)
    assert rel < GRAD_LIMIT, f"flash dropout fwd/bwd mask mismatch: rel {rel:.3e}"
    return {"rel": rel, "fd": fd, "analytic": an}


def check_small_attention_dropout_gradcheck(geo: Geometry, device):
    """B12 (`small_attention`) with dropout 0.2 at the frequency axis'
    shape, along dq."""
    from beat_this_tpu_torch.ops.small_attention import small_attention

    rng = np.random.RandomState(3)
    k, v, cot, q0 = (_randn(rng, geo.small, device) for _ in range(4))

    def loss(q):
        return _dot(small_attention(q, k, v, dropout_rate=0.2, seed=23), cot)

    rel, fd, an = _directional_gradcheck(loss, q0)
    assert rel < GRAD_LIMIT, f"small_attention dropout mask mismatch: rel {rel:.3e}"
    return {"rel": rel, "fd": fd, "analytic": an}


def check_fused_ff_dropout_gradcheck(geo: Geometry, device):
    """B8 / B9 (`fused_ff_train`) with dropout 0.2, along dx."""
    from beat_this_tpu_torch.ops.fused_ff import fused_ff_train

    rng = np.random.RandomState(6)
    rows, c, m = geo.ff
    ff = _ff_module({"norm_gamma": rng.rand(c) + 0.5, "w1": 0.05 * rng.randn(c, m),
                     "b1": 0.05 * rng.randn(m), "w2": 0.05 * rng.randn(m, c),
                     "b2": 0.05 * rng.randn(c)}, device)
    x0, cot = _randn(rng, (rows, c), device), _randn(rng, (rows, c), device)

    def loss(x):
        return _dot(fused_ff_train(x, ff, 0.2, 31), cot)

    rel, fd, an = _directional_gradcheck(loss, x0)
    assert rel < GRAD_LIMIT, f"fused_ff dropout VJP mismatch: rel {rel:.3e}"
    return {"rel": rel, "fd": fd, "analytic": an}


def check_fused_freq_dropout_gradcheck(geo: Geometry, device):
    """B6 / B7 (`freq_roformer` in training) with dropout 0.1 at the second
    frontend block (F 16, C 64, 2 heads) of the seed-0 model, along dx."""
    block = seed_model(geo.config, device).frontend.blocks[1].partial.requires_grad_(False)
    f, c = 16, 64
    rope = rope_tables(f, 32, device)
    x0 = torch.from_numpy(np.random.RandomState(4).randn(geo.freq_items, f, c)
                          .astype(np.float32)).to(device)
    cot = torch.from_numpy(np.random.RandomState(5).randn(geo.freq_items, f, c)
                           .astype(np.float32)).to(device)

    def loss(x):
        return _dot(freq_roformer(block.attnF, block.ffF, x, rope, c // 32, train=True,
                                  dropout_rate=0.1, seed=29), cot)

    rel, fd, an = _directional_gradcheck(loss, x0)
    assert rel < GRAD_LIMIT, f"fused_freq dropout VJP mismatch: rel {rel:.3e}"
    return {"rel": rel, "fd": fd, "analytic": an}


CHECKS = [
    ("fused_time_parity", check_fused_time_parity),
    ("fused_time_dropout_gradcheck", check_fused_time_dropout_gradcheck),
    ("eval_logit_parity", check_eval_logit_parity),
    ("flagship_train_steps", check_flagship_train_steps),
    ("beat_level_kernel_parity", check_beat_level_kernel_parity),
    ("train_grad_parity_no_dropout", check_train_grad_parity_no_dropout),
    ("train_dropout_finite", check_train_dropout_finite),
    ("dropout_statistics", check_dropout_statistics),
    ("flash_dropout_gradcheck", check_flash_dropout_gradcheck),
    ("small_attention_dropout_gradcheck", check_small_attention_dropout_gradcheck),
    ("fused_ff_dropout_gradcheck", check_fused_ff_dropout_gradcheck),
    ("fused_freq_dropout_gradcheck", check_fused_freq_dropout_gradcheck),
]


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m beat_this_tpu_torch.check_all",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="GPUCHECK.json")
    parser.add_argument("--only", nargs="*", default=None, metavar="CHECK",
                        help="run only the named checks (default: all)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu: the plain versions only")
    return parser


def main(argv=None, geometry: Geometry = FULL) -> int:
    """Run the checks, write the report to --out, print one line per check;
    0 when every check passed, 1 when one failed, 2 when CUDA is asked for
    and absent."""
    args = get_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("check_all: CUDA is not available; this gate runs on the card "
              "(--device cpu runs the plain versions only)", file=sys.stderr)
        return 2
    checks = CHECKS
    if args.only:
        unknown = set(args.only) - {n for n, _ in CHECKS}
        if unknown:
            raise SystemExit(f"unknown check(s): {sorted(unknown)}")
        checks = [(n, f) for n, f in CHECKS if n in args.only]
    cuda = device.type == "cuda"
    smi = nvidia_smi_line() if cuda else "cpu"
    report = {"platform": "gpu" if cuda else "cpu", "device": smi, "checks": {}}
    print(f"check_all on {smi}" + ("" if cuda else
                                   " (plain versions only: checks the plumbing)"), flush=True)
    ok = True
    for name, fn in checks:
        t0 = time.perf_counter()
        try:
            details = fn(geometry, device)
            status = {"ok": True, **{k: round(v, 6) if isinstance(v, float) else v
                                     for k, v in details.items()}}
        except Exception as exc:  # noqa: BLE001 - recorded in the report
            ok = False
            status = {"ok": False, "error": f"{type(exc).__name__}: {exc}",
                      "trace": traceback.format_exc(limit=3)}
        status["elapsed_s"] = round(time.perf_counter() - t0, 1)
        report["checks"][name] = status
        line = f"{name}: {'OK' if status['ok'] else 'FAIL'} ({status['elapsed_s']} s)"
        if name == "flagship_train_steps" and status["ok"]:
            peak = status["peak_gib"]
            line += (f"; {status['steps']} steps of {status['microbatches']} x "
                     f"{status['crops']} x {status['frames']}: step {status['step_s_median']:.3f} "
                     f"s median, {status['step_s_min']:.3f} s min, first "
                     f"{status['step_s_first']:.3f} s; peak memory "
                     + (f"{peak:.2f} GiB" if peak is not None else "not measured")
                     + f"; loss {status['loss_first']:.4f} -> {status['loss_last']:.4f} [{smi}]")
        print(line + ("" if status["ok"] else f": {status['error']}"), flush=True)
    report["ok"] = ok
    Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    print(("ALL OK" if ok else "FAILURES") + f" -> {args.out}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
