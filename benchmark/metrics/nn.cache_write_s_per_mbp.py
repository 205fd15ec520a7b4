"""Seconds of the window cache's compressed write
(``np.savez_compressed`` of the encoded windows) per Mbp: the port's
``nn.cache_write`` spans."""

from benchmark import program_spans


def read(ctx):
    return program_spans.seconds_per_mbp(ctx, "nn.cache_write")
