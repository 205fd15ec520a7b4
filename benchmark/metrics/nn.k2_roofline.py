"""K2 (``csrc/fused_reduce.cu``, the two IGLOO blocks' patch reduction,
value projection and max-pool) against its roofline, in %: the least time
of the blocks over every window the jobs hold, in the window's K2
launches, over K2's device time in the trace."""

from benchmark import peaks

NAMES = ("fused_reduce_tc", "fused_reduce_f32")


def read(ctx):
    device_s = ctx.device.seconds_of(lambda n: any(k in n for k in NAMES))
    launches = int(ctx.counters.get("k2_launches", 0))
    if device_s <= 0 or launches <= 0:
        return None
    return 100.0 * peaks.k2_least_seconds(ctx.widths, ctx.widths.igloo_blocks * ctx.windows, launches) / device_s
