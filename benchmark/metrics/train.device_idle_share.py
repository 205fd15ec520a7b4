"""The share of the training window in which no operation ran on the card,
in %: 1 - the union of the traced device operations' intervals / the window."""


def read(ctx):
    if not ctx.device.ops:
        return None
    return 100.0 * (1.0 - ctx.device.busy_s() / ctx.window_s)
