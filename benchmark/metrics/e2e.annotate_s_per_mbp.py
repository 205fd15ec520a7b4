"""Seconds in annotate (``modules.annotate.main``, on ``run_end_to_end``'s
worker thread) per Mbp of the window's jobs: the harness's span."""


def read(ctx):
    s = ctx.spans.total("annotate")
    return s / ctx.mbp if s > 0 and ctx.mbp > 0 else None
