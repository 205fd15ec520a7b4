"""Seconds of the input's checks per Mbp: the port's ``nn.check_fasta``
spans (empty input, repeated identifiers) and its ``md5`` spans (the input's
hash for the execution record, up to three a module call)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds_per_mbp(ctx, "nn.check_fasta", "md5")
