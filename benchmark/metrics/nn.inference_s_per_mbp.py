"""Seconds of the forward over all windows (``ops.nn_pipeline.predict_windows``:
host-to-card copies, the IGLOO model, the scores back to the host) per Mbp:
the harness's span."""


def read(ctx):
    s = ctx.spans.total("inference")
    return s / ctx.mbp if s > 0 and ctx.mbp > 0 else None
