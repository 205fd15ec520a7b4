"""Device seconds of the marker search's prefilter on the card (the kernels
of ``genomad_torch/csrc/prefilter.cu``, each named with ``prefilter_``) in
the window's trace per Mbp; None where no such kernel ran (a program that
prefilters on the host)."""


def read(ctx):
    s = ctx.device.seconds_of(lambda n: "prefilter_" in n)
    return s / ctx.mbp if s > 0 and ctx.mbp > 0 else None
