"""The share of the NN windows' positions that hold the contigs' bases, in
%: the bases ``encode_windows`` put into windows before the N padding
(the port's counter ``nn.window_bp``) over the windows classified
(``nn.windows``) times the window's length."""


def read(ctx):
    bp = ctx.counters.get("stats.nn.window_bp", 0.0)
    windows = ctx.counters.get("stats.nn.windows", 0.0)
    if bp <= 0 or windows <= 0:
        return None
    return 100.0 * bp / (windows * ctx.widths.window_bp)
