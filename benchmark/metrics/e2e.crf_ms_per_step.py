"""Milliseconds of the provirus CRF per gene position stepped: the port's
``fp.crf`` spans (through the scores' copy to the host) over its counter
``crf.steps``, as the window's change."""

from benchmark import program_spans


def read(ctx):
    steps = ctx.counters.get("stats.crf.steps", 0.0)
    crf = program_spans.total(program_spans.spans(ctx), "fp.crf")
    return 1e3 * crf / steps if crf > 0 and steps > 0 else None
