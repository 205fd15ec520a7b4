"""Seconds of the score tables' write (the npz and the tsv) per Mbp: the
port's ``nn.tables`` spans."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds_per_mbp(ctx, "nn.tables")
