"""Seconds in find-proviruses (``modules.find_proviruses.main``: the
integrase search, the CRF, tRNAs) per Mbp: the harness's span."""


def read(ctx):
    s = ctx.spans.total("find_proviruses")
    return s / ctx.mbp if s > 0 and ctx.mbp > 0 else None
