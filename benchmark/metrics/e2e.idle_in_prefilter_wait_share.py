"""The share of the window in which the card ran nothing while the marker
search waited for its prefilter, in %: the union of the port's
``search.prefilter_wait`` spans, less the traced device operations'
intervals, over the window."""

from benchmark import program_spans


def read(ctx):
    waits = sorted((max(s.t0, ctx.device.t0), min(s.t1, ctx.device.t1))
                   for s in program_spans.spans(ctx) if s.name == "search.prefilter_wait")
    if not waits or ctx.window_s <= 0:
        return None
    merged: list = []
    for s, e in waits:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    busy = ctx.device.busy_intervals()
    idle = 0.0
    for s, e in merged:
        idle += (e - s) - sum(max(0.0, min(e, be) - max(s, bs)) for bs, be in busy)
    return 100.0 * idle / ctx.window_s
