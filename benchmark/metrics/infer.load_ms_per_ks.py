"""`io`'s decode threads: the program's `load` spans (the thread pool that
decodes a group's files in `BatchedFile2File.process_many`) in the profiled
units, in ms per 1000 s of the audio their groups loaded (the `group`
spans' `audio_s`). None where the program records no session (a tree
without its own spans)."""

from beat_this_tpu_torch import profiler

NAME = "infer.load_ms_per_ks"


def read(ctx):
    session = getattr(profiler, "session", lambda: None)()
    if session is None or ctx.cell.work_name != "audio_s":
        return None
    audio_s = sum(g.audio_s or 0.0 for g in session.named("group"))
    if audio_s <= 0:
        raise RuntimeError(f"{NAME}: the program's session holds no group span with audio")
    return 1e6 * sum(s.seconds for s in session.named("load")) / audio_s
