"""K1's long body (``sw_slab_kernel`` of ``csrc/sw.cu``, the profile buckets
above 1,024 columns) against its roofline, in %: the least time of the DP
cells of the window's pairs in those buckets (the port's ``STATS``
``cells_forward_long`` and ``cells_reverse_long``, at real lengths, 12 lane
operations a cell at 33.5 T/s) over the long body's device time in the
trace of the same window."""

from benchmark import peaks


def read(ctx):
    device_s = ctx.device.seconds_of(lambda n: "sw_slab_kernel" in n)
    cells = ctx.counters.get("stats.cells_forward_long", 0.0) + ctx.counters.get("stats.cells_reverse_long", 0.0)
    if device_s <= 0 or cells <= 0:
        return None
    return 100.0 * peaks.k1_least_seconds(cells) / device_s
