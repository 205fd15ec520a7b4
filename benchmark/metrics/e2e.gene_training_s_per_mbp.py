"""Seconds of the gene caller's training on each input per Mbp: the port's
``gene_calling.train`` spans."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds_per_mbp(ctx, "gene_calling.train")
