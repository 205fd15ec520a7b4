"""The share of K1's DP cells that its long body computed, in %: the
window's cells of pairs whose profile bucket is above 1,024 columns
(``STATS`` ``cells_forward_long`` + ``cells_reverse_long``) over all of
K1's cells (``cells_forward`` + ``cells_reverse``), marker and integrase
searches, at real lengths."""


def read(ctx):
    c = ctx.counters
    long = c.get("stats.cells_forward_long", 0.0) + c.get("stats.cells_reverse_long", 0.0)
    cells = c.get("stats.cells_forward", 0.0) + c.get("stats.cells_reverse", 0.0)
    if cells <= 0 or "stats.cells_forward_long" not in c:
        return None
    return 100.0 * long / cells
