"""The share of the host prefilter's thread slots spent on query groups,
in %: the port's counters ``prefilter.thread_s`` (the workers' seconds in
their groups, summed over threads) over ``prefilter.slot_s`` (each call's
wall times its thread count), as the window's change."""

from benchmark import program_spans


def read(ctx):
    return program_spans.counter_ratio(ctx, "prefilter.thread_s", "prefilter.slot_s", 100.0)
