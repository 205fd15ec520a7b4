"""Seconds of window encoding (``ops.nn_pipeline.encode_windows``: FASTA
reading, windowing, base codes) per Mbp: the harness's span."""


def read(ctx):
    s = ctx.spans.total("encode")
    return s / ctx.mbp if s > 0 and ctx.mbp > 0 else None
