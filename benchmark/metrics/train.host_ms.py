"""`train.task`'s host time per step: the program's `step` spans (the whole
of `train_step`, which does not synchronize) in the profiled units, mean
ms per step. It is read only under the profiler, and so holds the
profiler's own host cost per op and range: it is the traced host time, not
the untraced one, and compares only against other traced runs. Where it
reads above the device's busy time per step, the host sets the pace of the
traced window, which the untraced cell need not share (its idle share
reads lower there). None where the program records no session (a tree
without its own spans)."""

from beat_this_tpu_torch import profiler


def read(ctx):
    session = getattr(profiler, "session", lambda: None)()
    if session is None or ctx.cell.work_name != "frames":
        return None
    steps = session.named("step")
    if not steps:
        raise RuntimeError("train.host_ms: the program's session holds no step span")
    return 1e3 * sum(s.seconds for s in steps) / len(steps)
