"""Seconds the marker search waited for its prefilter (the port's
``search.prefilter_wait`` spans: the search thread blocked on the next
group's prefilter, marker and integrase searches) per Mbp."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds_per_mbp(ctx, "search.prefilter_wait")
