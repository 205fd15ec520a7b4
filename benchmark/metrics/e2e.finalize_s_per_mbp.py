"""Seconds of the marker search's finalize step (stop rule, best hits) per
Mbp: the port's ``search.finalize`` spans."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds_per_mbp(ctx, "search.finalize")
