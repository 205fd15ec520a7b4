"""Seconds of the trainer's input per Mbp: the port's ``train.batches``
spans (window encoding, labels, shuffle and carry, the batches' copy to the
card and their tokens)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds_per_mbp(ctx, "train.batches")
