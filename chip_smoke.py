#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (beat_this_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero without the
final `"ok": true` line:

1. environment: GPU name and power limit, torch / CUDA / nvcc versions;
2. build: compiles the CUDA kernels from this checkout's sources;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the main path's shapes, in float32 (TF32 off, relative max
   deviation <= 1e-3) and bfloat16 (< 2.5e-2), with median times;
4. end to end: the full-width BeatThisConfig() model from a numpy-seeded
   synthetic checkpoint runs the port's CLI in-process on a 75 s click
   track (three chunks) and a 12 s one (the short-piece path), in float32
   and with --float16. The checkpoint is random except for its input batch
   norm (the long piece's log-mel statistics) and its task head, fit by
   least squares on the plain float32 path's features to the long piece's
   clicks, so the logits peak at the clicks as a trained model's peak at
   beats. Checks: the .beats files parse, every kernel's launch counter
   went up, the logits agree with the plain path of the same dtype on the
   card within the phase-3 limits, and the beats agree with the float32
   plain path's at F >= 0.999;
5. the kernel summary JSON, then the device JSON as the last line.

Needs a CUDA device and the repository beside this script; it never runs
on the CPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np

F32_LIMIT = 1e-3  # relative max deviation, float32 with TF32 off
BF16_LIMIT = 2.5e-2  # relative max deviation, bfloat16 (tools/check_all_tpu.py:71)
F_MIN = 0.999  # beat F-measure of the kernel path against the float32 plain path
SR = 22050
HOP = 441
FPS = SR // HOP

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "fused_ff": ("beat_this_tpu_torch/csrc/fused_ff.cu", "beat_this_tpu/ops/fused_ff.py:55"),
    "fused_time_roformer": (
        "beat_this_tpu_torch/csrc/fused_time.cu", "beat_this_tpu/ops/fused_time.py:114"),
    "fused_freq_roformer": (
        "beat_this_tpu_torch/csrc/fused_freq.cu", "beat_this_tpu/ops/fused_freq.py:275"),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def rel_dev(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def median_ms(fn, reps: int = 10) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 1 -----------------------------------------------------------------


def phase_environment() -> str:
    import torch

    smi = nvidia_smi_line()
    print(f"[env] gpu: {smi}")
    from beat_this_tpu_torch.ops import _build

    nvcc = subprocess.run(
        [_build._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    print(f"[env] torch.cuda.get_device_name(0) = {torch.cuda.get_device_name(0)}, "
          f"device_count = {torch.cuda.device_count()}")
    return smi


# -- phase 2 -----------------------------------------------------------------


def phase_build() -> None:
    from beat_this_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"[build] {path} in {time.perf_counter() - t0:.1f} s")
    log = path.parent / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "spill" in line and not line.strip().endswith("0 bytes spill loads"):
                print(f"[build] ptxas: {line.strip()}")


# -- phase 3 -----------------------------------------------------------------


def random_block(c: int, heads: int, seed: int, device):
    """An Attention and a FeedForward module with numpy-seeded weights at the
    scales the JAX package's kernel tests use."""
    import torch

    from beat_this_tpu_torch.model.layers import Attention, FeedForward

    rng = np.random.default_rng(seed)
    m = 4 * c

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    attn, ff = Attention(c, heads), FeedForward(c)
    with torch.no_grad():
        attn.norm.gamma.copy_(t(1 + 0.1 * rng.standard_normal(c)))
        attn.to_qkv.weight.copy_(t(rng.standard_normal((3 * c, c)) / np.sqrt(c)))
        attn.to_gates.weight.copy_(t(rng.standard_normal((heads, c)) / np.sqrt(c)))
        attn.to_gates.bias.copy_(t(0.3 * rng.standard_normal(heads)))
        attn.to_out[0].weight.copy_(t(rng.standard_normal((c, c)) / np.sqrt(c)))
        norm, lin1, _, _, lin2, _ = ff.net
        norm.gamma.copy_(t(1 + 0.1 * rng.standard_normal(c)))
        lin1.weight.copy_(t(rng.standard_normal((m, c)) / np.sqrt(c)))
        lin1.bias.copy_(t(0.1 * rng.standard_normal(m)))
        lin2.weight.copy_(t(rng.standard_normal((c, m)) / np.sqrt(m)))
        lin2.bias.copy_(t(0.1 * rng.standard_normal(c)))
    return attn.to(device).requires_grad_(False), ff.to(device).requires_grad_(False)


def phase_kernels(smi: str) -> dict:
    import torch

    from beat_this_tpu_torch.ops.fused_ff import fused_ff, fused_ff_ref
    from beat_this_tpu_torch.ops.fused_freq import fused_freq_roformer, fused_freq_roformer_ref
    from beat_this_tpu_torch.ops.fused_time import fused_time_roformer, fused_time_roformer_ref
    from beat_this_tpu_torch.ops.rotary import rope_tables

    dev = torch.device("cuda", 0)
    cases = []
    # K2: a main transformer layer over 2 chunks, frontend block 0's time
    # direction (B * F = 64 sequences of C = 32)
    for c, heads, n, items in ((512, 16, 1500, 2), (32, 1, 1500, 64)):
        attn, ff = random_block(c, heads, c + n, dev)
        cos, sin = rope_tables(n, 32, dev)
        cases.append(("fused_time_roformer", f"C={c} heads={heads} n={n} items={items}",
                      (items, n, c),
                      lambda x, a=attn, f=ff, cs=cos, sn=sin, h=heads:
                          fused_time_roformer(x, a, f, cs, sn, h),
                      lambda x, a=attn, f=ff, cs=cos, sn=sin, h=heads:
                          fused_time_roformer_ref(x, a, f, cs, sn, h)))
    # K3: frontend blocks 0 and 2 over 2 chunks (B * T = 3000 items)
    for f_bins, c, items in ((32, 32, 3000), (8, 128, 3000)):
        attn, ff = random_block(c, c // 32, f_bins + c, dev)
        cos, sin = rope_tables(f_bins, 32, dev)
        cases.append(("fused_freq_roformer", f"F={f_bins} C={c} items={items}",
                      (items, f_bins, c),
                      lambda x, a=attn, f=ff, cs=cos, sn=sin: fused_freq_roformer(x, a, f, cs, sn),
                      lambda x, a=attn, f=ff, cs=cos, sn=sin:
                          fused_freq_roformer_ref(x, a, f, cs, sn)))
    # K1: the short-piece path at a 768-frame bucket: a main layer (1 x 768
    # rows of C = 512) and frontend block 0's time FF (32 x 768 rows of C = 32)
    for c, items, n in ((512, 1, 768), (32, 32, 768)):
        _, ff = random_block(c, c // 32, 7 * c, dev)
        cases.append(("fused_ff", f"C={c} rows={items * n}", (items, n, c),
                      lambda x, f=ff: fused_ff(x, f),
                      lambda x, f=ff: fused_ff_ref(x, f)))

    results = {name: [] for name in KERNELS}
    for dtype, limit in ((torch.float32, F32_LIMIT), (torch.bfloat16, BF16_LIMIT)):
        for name, desc, shape, kernel, plain in cases:
            gen = torch.Generator(device=dev).manual_seed(len(results[name]))
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            with torch.inference_mode():
                got = kernel(x)
                want = plain(x)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got.float()).all()), f"{name} {desc}: non-finite")
                dev_rel = rel_dev(got, want)
                abs_err = float((got.float() - want.float()).abs().max())
                ms = median_ms(lambda: kernel(x))
                plain_ms = median_ms(lambda: plain(x))
            dt = "f32" if dtype == torch.float32 else "bf16"
            ok = dev_rel <= limit if dtype == torch.float32 else dev_rel < limit
            print(f"[kernels] {name} {dt} {desc}: rel max dev {dev_rel:.3e} (limit {limit:g}) "
                  f"abs {abs_err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
                  f"[{smi}] {'ok' if ok else 'FAIL'}")
            check(ok, f"{name} {dt} {desc}: deviation {dev_rel:.3e} over {limit:g}")
            results[name].append({"case": f"{dt} {desc}", "rel_max_dev": dev_rel,
                                  "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms})
    return results


# -- phase 4 -----------------------------------------------------------------


def click_onsets(frames: int) -> np.ndarray:
    """Onset times (s) of the click track: 120 bpm from 0.25 s; every fourth
    click, from the first, is a downbeat, louder and higher as a
    metronome's."""
    return np.arange(0.25, (frames - 1) * HOP / SR, 0.5)


def click_frames(frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Frames where the beat and downbeat logits should peak: the first
    frame centred after each onset, which holds the click's attack."""
    beats = np.floor(click_onsets(frames) * FPS) + 1
    return beats, beats[::4]


def write_wav(path: Path, frames: int, seed: int) -> float:
    """A 16-bit click track (click_onsets) plus noise, long enough for
    `frames` model frames; returns its duration in seconds."""
    rng = np.random.default_rng(seed)
    n = (frames - 1) * HOP
    t = np.arange(n) / SR
    x = 0.02 * rng.standard_normal(n)
    for i, onset in enumerate(click_onsets(frames)):
        k = int(onset * SR)
        seg = t[: min(2205, n - k)]
        amp, hz = (0.6, 1500) if i % 4 == 0 else (0.3, 1000)
        x[k : k + len(seg)] += amp * np.sin(2 * np.pi * hz * seg) * np.exp(-seg / 0.02)
    pcm = np.clip(np.round(x * 32767), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())
    return n / SR


def read_beats(path: Path) -> tuple[np.ndarray, np.ndarray]:
    rows = [line.split("\t") for line in path.read_text().splitlines() if line.strip()]
    times = np.array([float(r[0]) for r in rows])
    numbers = np.array([int(r[1]) for r in rows])
    return times, times[numbers == 1]


def f_measure(est: np.ndarray, ref: np.ndarray, window: float = 0.07) -> float:
    """Beat F-measure with a +/-70 ms window and one-to-one greedy matching."""
    if len(est) == 0 and len(ref) == 0:
        return 1.0
    if len(est) == 0 or len(ref) == 0:
        return 0.0
    used = np.zeros(len(est), bool)
    hits = 0
    for r in ref:
        d = np.abs(est - r)
        d[used] = np.inf
        j = int(np.argmin(d))
        if d[j] <= window:
            used[j] = True
            hits += 1
    p, r = hits / len(est), hits / len(ref)
    return 0.0 if hits == 0 else 2 * p * r / (p + r)


def read_pcm(path: Path) -> np.ndarray:
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def fit_head(state: dict, config, spect, frames: int) -> str:
    """Set the task head of `state` to the ridge least-squares fit, on the
    plain float32 path's features of `spect` (two chunk-long windows that
    cover it), of targets that are +1 at the click frames, fall off over
    about a frame and are -1 elsewhere. Frames with positive and negative
    targets weigh half each, so the rare downbeats are not fit towards the
    background. Returns a line on the fit."""
    import torch

    from beat_this_tpu_torch.model import BeatThis

    model = BeatThis(config)
    model.load_state_dict(state)
    model = model.to(spect.device).eval()
    t = len(spect)
    pos = np.arange(t)

    def bumps(centers):
        d = np.abs(pos[:, None] - centers[None, :]).min(1)
        return -1.0 + 2.0 * np.exp(-0.5 * d.astype(np.float64) ** 2)

    targets = torch.from_numpy(np.stack([bumps(c) for c in click_frames(frames)], 1))
    targets = targets.to(spect.device)
    xs, ys = [], []
    with torch.inference_mode():
        for a in sorted({0, max(t - 1500, 0)}):
            h = model.features(spect[None, a : a + 1500], kernels=False)[0].double()
            xs.append(torch.cat([h, torch.ones_like(h[:, :1])], 1))
            ys.append(targets[a : a + 1500])
    x, y = torch.cat(xs), torch.cat(ys)
    coef = []
    for target in y.T:
        positive = target > 0
        weight = torch.where(positive, 0.5 / positive.sum(), 0.5 / (~positive).sum())
        gram = (x * weight[:, None]).T @ x
        gram.diagonal()[:-1] += 1e-3 * gram.diagonal()[:-1].mean()  # ridge, bias unpenalized
        coef.append(torch.linalg.solve(gram, (x * weight[:, None]).T @ target))
    coef = torch.stack(coef, 1)  # (C + 1, 2)
    rms = float((x @ coef - y).square().mean().sqrt())
    w, b = coef[:-1].T.float().cpu(), coef[-1].float().cpu()
    if config.sum_head:  # the beat logit is the sum of both head outputs
        w[0] -= w[1]
        b[0] -= b[1]
    state["task_heads.beat_downbeat_lin.weight"] = w
    state["task_heads.beat_downbeat_lin.bias"] = b
    return (f"head fit on {len(x)} frames: target rms residual {rms:.3f}, "
            f"weight norm {float(w.norm()):.2f}")


def phase_end_to_end(smi: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return _end_to_end(Path(tmp), smi)


def _end_to_end(tmp: Path, smi: str) -> dict:
    import torch
    from torch import nn

    from beat_this_tpu_torch import cli
    from beat_this_tpu_torch.inference import Audio2Beats, ChunkedPredictor
    from beat_this_tpu_torch.io.checkpoint import init_beat_this
    from beat_this_tpu_torch.model import BeatThisConfig
    from beat_this_tpu_torch.ops.fused_ff import fused_ff
    from beat_this_tpu_torch.ops.fused_freq import fused_freq_roformer
    from beat_this_tpu_torch.ops.fused_time import fused_time_roformer
    from beat_this_tpu_torch.ops.mel import log_mel_spectrogram

    counters = {"fused_ff": fused_ff, "fused_time_roformer": fused_time_roformer,
                "fused_freq_roformer": fused_freq_roformer}

    class Composable(nn.Module):
        """The model with every router on its composable path (the kernels'
        plain versions)."""

        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, x, **kwargs):
            return self.model(x, kernels=False, **kwargs)

    pieces = {"long": (tmp / "long.wav", 3750), "short": (tmp / "short.wav", 601)}
    durations = {k: write_wav(p, frames, i) for i, (k, (p, frames)) in enumerate(pieces.items())}
    config = BeatThisConfig()
    state = init_beat_this(0, config)
    # a trained checkpoint's input batch norm holds the log-mel statistics of
    # its data; with the init's identity statistics the log-mel offset (~3.5)
    # swamps the random network and its logits hardly vary. Its head makes
    # the logits peak at beats; with a random head they are noise-like and
    # rounding moves their peaks.
    mel = log_mel_spectrogram(torch.from_numpy(read_pcm(pieces["long"][0]).copy()).cuda())
    state["frontend.stem.bn1d.running_mean"] = mel.mean(0).cpu()
    state["frontend.stem.bn1d.running_var"] = mel.var(0).cpu()
    fit = fit_head(state, config, mel, pieces["long"][1])
    n_params = sum(v.numel() for k, v in state.items() if "running" not in k)
    ckpt = tmp / "synthetic.ckpt"
    torch.save({"state_dict": {"model." + k: v for k, v in state.items()},
                "hyper_parameters": {}}, ckpt)
    print(f"[e2e] synthetic checkpoint: BeatThisConfig() defaults, {n_params} parameters, "
          f"seed 0, input batch norm from the long piece's log-mel statistics, {fit}")

    def run_cli(wav: Path, out: Path, float16: bool) -> float:
        t0 = time.perf_counter()
        cli.run([str(wav)], str(ckpt), str(out), ".beats", False, False, False, False,
                0, float16, False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for float16 in (False, True):  # CUDA context, library load, cuDNN algorithm choice
        run_cli(pieces["short"][0], tmp / "warmup.beats", float16)

    runs = []
    for name in counters:
        counters[name].launches = 0
    for piece, (wav, frames) in pieces.items():
        for float16 in (False, True):
            before = {k: fn.launches for k, fn in counters.items()}
            out = tmp / f"{piece}{'_bf16' if float16 else ''}.beats"
            wall = run_cli(wav, out, float16)
            delta = {k: fn.launches - before[k] for k, fn in counters.items()}
            runs.append((piece, float16, out, wall, delta))
    launches = {k: fn.launches for k, fn in counters.items()}

    for piece, float16, out, wall, delta in runs:
        dt = "bf16" if float16 else "f32"
        print(f"[e2e] cli {piece} ({durations[piece]:.1f} s audio) {dt}: {wall:.3f} s wall "
              f"(checkpoint load included), {durations[piece] / wall:.1f}x realtime, "
              f"launches {delta} [{smi}]")
        expect = (("fused_time_roformer", "fused_freq_roformer") if piece == "long"
                  else ("fused_ff", "fused_freq_roformer"))
        for k in expect:
            check(delta[k] > 0, f"{piece} {dt}: kernel {k} was not launched")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was never launched on the main path")

    # references from the plain path on the card, float32
    tower = Audio2Beats(str(ckpt), "cuda", False)
    refs = {}
    for piece, (wav, frames) in pieces.items():
        spect = tower.signal2spect(read_pcm(wav) / 32768.0, SR)
        check(spect.shape == (frames, 128), f"{piece}: spect shape {spect.shape}")
        logits = ChunkedPredictor(Composable(tower.model)).predict(spect)
        refs[piece] = (spect, logits, tower.frames2beats(*logits))

    for piece, float16, out, _, _ in runs:
        dt = "bf16" if float16 else "f32"
        spect, ref_logits, (ref_beats, ref_down) = refs[piece]
        beats, downbeats = read_beats(out)
        check(len(beats) > 0 and len(downbeats) > 0 and bool(np.all(np.diff(beats) > 0)),
              f"{out.name}: bad beats")
        tower = Audio2Beats(str(ckpt), "cuda", float16)
        got = tower.spect2frames(spect)
        plain = ref_logits
        if float16:
            plain = ChunkedPredictor(
                Composable(tower.model), compute_dtype=torch.bfloat16
            ).predict(spect)
        for g in got:
            check(g.shape == (len(spect),) and bool(np.isfinite(g).all()), f"{piece}: bad logits")
        dev_rel = max(rel_dev(torch.from_numpy(g), torch.from_numpy(w)) for g, w in zip(got, plain))
        limit = BF16_LIMIT if float16 else F32_LIMIT
        f_beat, f_down = f_measure(beats, ref_beats), f_measure(downbeats, ref_down)
        true_beats, true_down = (f / FPS for f in click_frames(pieces[piece][1]))
        print(f"[e2e] {piece} {dt}: logits vs plain {dt} path rel max dev {dev_rel:.3e} "
              f"(limit {limit:g}); vs plain f32 beats: beats {len(beats)} F {f_beat:.4f}, "
              f"downbeats {len(downbeats)} F {f_down:.4f} (min {F_MIN}); vs the clicks "
              f"({len(true_beats)} / {len(true_down)}): F {f_measure(beats, true_beats):.4f} / "
              f"{f_measure(downbeats, true_down):.4f}")
        check(dev_rel < limit if float16 else dev_rel <= limit,
              f"{piece} {dt}: logits deviate {dev_rel:.3e}")
        check(f_beat >= F_MIN and f_down >= F_MIN, f"{piece} {dt}: beats disagree")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    try:
        import beat_this_tpu_torch
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 1
    if Path(beat_this_tpu_torch.__file__).resolve().parent.parent != here:
        print("chip_smoke: imported a beat_this_tpu_torch from elsewhere", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = phase_environment()
        phase_build()
        results = phase_kernels(smi)
        launches = phase_end_to_end(smi)
        check("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    summary = []
    for name, (source, replaces) in KERNELS.items():
        main_case = results[name][0]  # the first float32 case
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results[name]),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "cases": results[name],
        })
    print(f"[summary] {smi}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
