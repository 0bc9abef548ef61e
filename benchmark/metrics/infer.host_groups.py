"""`inference`: groups in the traced window whose device path failed and
ran again on the host path (`BatchedFile2File.host_groups`)."""


def read(ctx):
    return ctx.counters.get("host_groups")
