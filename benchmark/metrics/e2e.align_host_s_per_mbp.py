"""Host seconds of the marker search's alignment per Mbp: the port's
``search.align`` spans (one K1 pass over a group's pairs: bucket grouping,
query staging, bucket fetch, launches) less the ``search.align.sync`` spans
inside them (the copy of the results, which waits for the card)."""

from benchmark import program_spans


def read(ctx):
    recorded = program_spans.spans(ctx)
    align = program_spans.total(recorded, "search.align")
    if align <= 0:
        return None
    sync = sum(s.t1 - s.t0 for s in program_spans.within(recorded, "search.align.sync", "search.align"))
    return program_spans.per_mbp(ctx, align - sync)
