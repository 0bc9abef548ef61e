"""`inference`'s padding: of the frames the profiled units' forwards ran
(rows x T, the program's `forward_frames` counter), the share that masked
rows ran past their valid length (`masked_frames`), in %: frames a bucketed
forward computes and masks out. The counters' change since the program's
session began. None where the program records no session (a tree without
its own spans)."""

from beat_this_tpu_torch import profiler


def read(ctx):
    session = getattr(profiler, "session", lambda: None)()
    if session is None or ctx.cell.work_name != "audio_s":
        return None
    now, then = profiler.counters, session.counters
    frames = now["forward_frames"] - then["forward_frames"]
    if frames <= 0:
        raise RuntimeError("infer.pad_share: the program counted no forward in its session")
    return 100.0 * (now["masked_frames"] - then["masked_frames"]) / frames
