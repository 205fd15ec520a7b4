"""The training step's share of the card's float32 peak, in %: three times
the IGLOO forward's model FLOPs (forward, and the backward's two products a
forward product; ``benchmark.peaks.igloo_forward_flops`` from the published
widths) over the windows the trainer trained in the window (the port's
counter ``train.windows``), over the window at 67 TFLOP/s."""

from benchmark import peaks


def read(ctx):
    windows = ctx.counters.get("stats.train.windows", 0.0)
    if windows <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * peaks.least_seconds(f32_flops=3 * peaks.igloo_forward_flops(ctx.widths, int(windows))) / ctx.window_s
