"""Nanoseconds of prefilter worker time per k-mer index hit: the port's
counters ``prefilter.thread_s`` over ``prefilter.hits``, as the window's
change."""

from benchmark import program_spans


def read(ctx):
    return program_spans.counter_ratio(ctx, "prefilter.thread_s", "prefilter.hits", 1e9)
