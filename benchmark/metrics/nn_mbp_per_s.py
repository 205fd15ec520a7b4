"""Input Mbp of every job started in the window over the time from the
window's start to the last job's end, for the ``nn-classification``
module."""


def read(ctx):
    return ctx.mbp / ctx.window_s
