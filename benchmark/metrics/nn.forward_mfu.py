"""The forward's share of the card's bf16 peak, in %: the IGLOO model
FLOPs of the windows the jobs hold (counted from the published widths,
``benchmark.peaks.igloo_forward_flops``) over the inference spans at
989 TFLOP/s."""

from benchmark import peaks


def read(ctx):
    return peaks.mfu_percent(peaks.igloo_forward_flops(ctx.widths, ctx.windows), ctx.spans.total("inference"))
