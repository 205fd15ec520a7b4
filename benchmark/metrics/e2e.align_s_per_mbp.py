"""Seconds of the marker search's alignment stages (``_PairAligner``: K1's
forward and reverse passes with their host work, and the finalize step)
per Mbp: the change of ``STATS`` ``sw_forward_s + sw_reverse_s +
finalize_s`` over the annotate spans."""


def read(ctx):
    s = ctx.spans.stats_total("annotate", ["sw_forward_s", "sw_reverse_s", "finalize_s"])
    return s / ctx.mbp if s > 0 and ctx.mbp > 0 else None
