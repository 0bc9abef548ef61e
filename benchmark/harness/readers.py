"""What the per-layer readers share: span time per 1000 s of audio, the
device's idle share, a kernel family's share of its roofline and a window's
share of the peak. A reader that finds nothing to read returns None."""

from __future__ import annotations

from harness import geometry


def span_ms_per_ks(ctx, name: str):
    if ctx.cell.work_name != "audio_s" or name not in ctx.span_s or ctx.work <= 0:
        return None
    return 1e3 * ctx.span_s[name] / (ctx.work / 1e3)


def idle_share(ctx) -> float:
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def roofline(ctx, family: str):
    """100 x the least time the card could take for the family's calls in
    the profiled window (operations over the bf16 peak or bytes over the
    memory's, whichever is longer) over the device time of its kernels.
    The calls come from the forwards the window ran; the op entries'
    launch counters and one anchor kernel per call check their count."""
    fam = ctx.reg.family(family)
    cfg, traffic = ctx.cell.cfg, ctx.cell.traffic
    if any(ctx.launches[f"{m}:{a}"] for m, a in getattr(fam, "EXCLUSIVE", ())):
        return None
    calls = fam.calls(cfg, ctx.profiled)
    if not calls:
        return None
    launched = sum(ctx.launches[f"{m}:{a}"] for m, a in fam.COUNTERS)
    anchors = ctx.trace.kernel_count(fam.ANCHOR)
    if not launched == anchors == len(calls):
        raise RuntimeError(f"{family}: {len(calls)} calls by the work model, {launched} by the "
                           f"launch counters, {anchors} {fam.ANCHOR} kernels in the trace")
    seconds = ctx.trace.kernel_seconds(fam.NAMES)
    peak = ctx.peaks
    least = 0.0
    for call in calls:
        flops, nbytes = fam.work(call, geometry.act_bytes(traffic))
        least += max(flops / peak["bf16_dense_flops_per_s"], nbytes / peak["hbm_bytes_per_s"])
    return 100.0 * least / seconds


def mfu(ctx, passes: int):
    """100 x `passes` forwards' operations of the work the profiled window
    completed, over the window's length at the bf16 peak. The forwards are
    the reference's (`cell.model_work`): each file's chunks, or a short
    piece at its own length, and not the program's padded calls, so
    padding counts as no work."""
    if not ctx.model_work:
        return None
    flops = passes * sum(geometry.forward_flops(ctx.cell.cfg, rows, frames)
                         for rows, frames in ctx.model_work)
    return 100.0 * flops / (ctx.trace.window_s * ctx.peaks["bf16_dense_flops_per_s"])
