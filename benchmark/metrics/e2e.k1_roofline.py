"""K1 (``csrc/sw.cu``, both bodies) against its roofline, in %: the least
time of the DP cells the window's searches computed (the port's ``STATS``
cells at real lengths, marker and integrase searches, forward and reverse,
12 lane operations a cell at 33.5 T/s) over K1's device time in the
trace of the same window."""

from benchmark import peaks

NAMES = ("sw_chunk_kernel", "sw_slab_kernel")


def read(ctx):
    device_s = ctx.device.seconds_of(lambda n: any(k in n for k in NAMES))
    cells = ctx.counters.get("stats.cells_forward", 0.0) + ctx.counters.get("stats.cells_reverse", 0.0)
    if device_s <= 0 or cells <= 0:
        return None
    return 100.0 * peaks.k1_least_seconds(cells) / device_s
