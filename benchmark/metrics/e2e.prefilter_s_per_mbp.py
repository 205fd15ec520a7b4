"""Seconds of the host prefilter (``native/prefilter.cpp`` through
``ops.protein_search``) in the marker search per Mbp: the change of the
port's ``STATS["prefilter_s"]`` over the annotate spans."""


def read(ctx):
    s = ctx.spans.stats_total("annotate", ["prefilter_s"])
    return s / ctx.mbp if s > 0 and ctx.mbp > 0 else None
