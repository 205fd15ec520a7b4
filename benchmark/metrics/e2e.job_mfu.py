"""The whole job's share of the card's peak over the window, in %: the
least time of the work the jobs need on the card (the IGLOO forward's
model FLOPs over the contigs' windows at the bf16 tensor-core peak, and
K1's DP cells at its lane-operation peak) over the window's length. It
bounds what any kernel's gain can show end to end."""

from benchmark import peaks


def read(ctx):
    cells = ctx.counters.get("stats.cells_forward", 0.0) + ctx.counters.get("stats.cells_reverse", 0.0)
    return peaks.mfu_percent(peaks.igloo_forward_flops(ctx.widths, ctx.windows), ctx.window_s, lane_ops=cells * peaks.SW_OPS_PER_CELL)
