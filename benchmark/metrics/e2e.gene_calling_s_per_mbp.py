"""Seconds in gene calling (``ops.gene_calling.Prodigal.run_parallel_prodigal``)
per Mbp: the harness's span."""


def read(ctx):
    s = ctx.spans.total("gene_calling")
    return s / ctx.mbp if s > 0 and ctx.mbp > 0 else None
