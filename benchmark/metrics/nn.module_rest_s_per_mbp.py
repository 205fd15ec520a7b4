"""Seconds of the nn-classification module outside encoding and inference
(``modules.nn_classification.main``: the window cache's compressed write,
the execution record, the score tables) per Mbp: the module span minus
the encode and inference spans."""


def read(ctx):
    module = ctx.spans.total("nn_module")
    if module <= 0 or ctx.mbp <= 0:
        return None
    return (module - ctx.spans.total("encode") - ctx.spans.total("inference")) / ctx.mbp
