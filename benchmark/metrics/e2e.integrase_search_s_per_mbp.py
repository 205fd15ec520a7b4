"""Seconds of find-proviruses' integrase search (the target proteins'
FASTA and the search through K1) per Mbp: the port's
``fp.integrase_search`` spans."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds_per_mbp(ctx, "fp.integrase_search")
