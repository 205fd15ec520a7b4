"""Seconds the marker search waited for the card per Mbp: the port's
``search.align.sync`` spans (the copy of K1's results to the host, which
waits for the launches before it)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds_per_mbp(ctx, "search.align.sync")
