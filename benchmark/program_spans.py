"""The port's own spans (``genomad_torch.trace``) for the per-layer metrics
that read them: the spans that ran inside the traced window. The port
records them while ``torch.profiler`` records, which a ``--trace 1`` run
does over exactly its window. A port without the tracer gives none, and
its readers then return ``None``."""

from __future__ import annotations


def spans(ctx) -> list:
    """The port's spans that began and ended inside the window."""
    if ctx.device is None:
        return []
    try:
        from genomad_torch import trace
    except ImportError:
        return []
    t0, t1 = ctx.device.t0, ctx.device.t1
    return [s for s in trace.spans() if t0 <= s.t0 and s.t1 <= t1]


def total(recorded: list, name: str) -> float:
    return sum(s.t1 - s.t0 for s in recorded if s.name == name)


def per_mbp(ctx, seconds: float):
    return seconds / ctx.mbp if seconds > 0 and ctx.mbp > 0 else None


def seconds_per_mbp(ctx, *names: str):
    """The summed seconds of the spans ``names`` per Mbp of the jobs run."""
    recorded = spans(ctx)
    return per_mbp(ctx, sum(total(recorded, n) for n in names))


def within(recorded: list, inner: str, outer: str) -> list:
    """The spans ``inner`` that some span ``outer`` encloses, at any depth."""
    by_id = {s.id: s for s in recorded}
    found = []
    for s in recorded:
        if s.name != inner:
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != outer:
            p = by_id.get(p.parent)
        if p is not None:
            found.append(s)
    return found


def counter_ratio(ctx, num: str, den: str, scale: float):
    """``scale`` x the window's change of the port's counter ``num`` over
    that of ``den`` (``stats.<key>``), or None where ``den`` did not move."""
    n, d = ctx.counters.get(f"stats.{num}", 0.0), ctx.counters.get(f"stats.{den}", 0.0)
    return scale * n / d if n > 0 and d > 0 else None
