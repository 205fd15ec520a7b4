"""K4 (``csrc/causal_conv.cu``, conv2 and conv3) against its roofline, in
%: the least time of two convolutions over every window the jobs hold, in
the window's K4 launches, over K4's device time in the trace."""

from benchmark import peaks

NAMES = ("causal_conv_bf16", "causal_conv_f32")


def read(ctx):
    device_s = ctx.device.seconds_of(lambda n: any(k in n for k in NAMES))
    launches = int(ctx.counters.get("k4_launches", 0))
    if device_s <= 0 or launches <= 0:
        return None
    return 100.0 * peaks.k4_least_seconds(ctx.widths, 2 * ctx.windows, launches) / device_s
