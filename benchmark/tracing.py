"""What a traced run (``--trace 1``) records, and the reading of it.

- Spans: the harness's own wrappers around the calls into each layer of the
  port (as a configuration's entry names them), each with its host-clock
  start and end, the job it belongs to and, where asked, the change of the
  port's ``protein_search.STATS`` over the call.
- Counters: the port's own (kernel launch counts, ``STATS``), read as the
  change over the window.
- Device operations: ``torch.profiler``'s CUDA activity over the window
  (kernels, copies, sets), with a marker that puts the host's spans on the
  trace's clock.

A run without ``--trace 1`` installs none of this.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


def _snapshot(stats) -> dict:
    return {k: float(v) for k, v in list(stats.items())}


def delta(after: dict, before: dict) -> dict:
    return {k: after.get(k, 0.0) - before.get(k, 0.0) for k in set(after) | set(before)}


class Spans:
    """Wraps ``owner.attr`` (a module function or a class's method) so that
    each call records a span. ``stats``: a dict-like counter of the port
    whose change over the call the span keeps."""

    def __init__(self):
        self.spans: list[dict] = []
        self.job = None
        self._saved: list = []
        self._lock = threading.Lock()

    def wrap(self, owner, attr: str, name: str, stats=None) -> None:
        original = getattr(owner, attr)
        self._saved.append((owner, attr, original))

        def timed(*args, **kwargs):
            before = _snapshot(stats) if stats is not None else None
            t0 = time.perf_counter()
            try:
                return original(*args, **kwargs)
            finally:
                rec = {"name": name, "t0": t0, "t1": time.perf_counter(), "job": self.job}
                if stats is not None:
                    rec["stats"] = delta(_snapshot(stats), before)
                with self._lock:
                    self.spans.append(rec)

        setattr(owner, attr, timed)

    def restore(self) -> None:
        for owner, attr, original in reversed(self._saved):
            setattr(owner, attr, original)
        self._saved.clear()

    def total(self, name: str) -> float:
        return sum(s["t1"] - s["t0"] for s in self.spans if s["name"] == name)

    def stats_total(self, name: str, keys) -> float:
        return sum(s["stats"].get(k, 0.0) for s in self.spans if s["name"] == name and "stats" in s for k in keys)


@dataclass
class DeviceTrace:
    """Device operations of the window on the host's perf_counter clock:
    (name, start s, end s) sorted by start."""

    ops: list = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0

    def busy_intervals(self) -> list:
        merged: list = []
        for _, s, e in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def seconds_of(self, match) -> float:
        """Summed device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.ops if match(n))

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, spans: list, n: int = 10) -> list:
        """Idle device time in the window, summed by the innermost harness
        span open on the host at each gap's middle ("window" where none is)."""
        gaps, prev = [], self.t0
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        by: dict = {}
        for s, e in gaps:
            mid = (s + e) / 2
            open_spans = [sp for sp in spans if sp["t0"] <= mid <= sp["t1"]]
            name = min(open_spans, key=lambda sp: sp["t1"] - sp["t0"])["name"] if open_spans else "window"
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


MARKER = "benchmark.window_marker"


class Profiler:
    """torch.profiler over the window; ``marker()`` ties its clock to
    perf_counter."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._host = None

    def __enter__(self):
        self._prof.__enter__()
        from torch.profiler import record_function

        self._host = time.perf_counter()
        with record_function(MARKER):
            pass
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def read(self, t0: float, t1: float) -> DeviceTrace:
        events = self._prof.profiler.kineto_results.events()
        marker = next(e for e in events if e.name() == MARKER)
        offset = self._host - marker.start_ns() * 1e-9
        ops = [
            (e.name(), e.start_ns() * 1e-9 + offset, (e.start_ns() + e.duration_ns()) * 1e-9 + offset)
            for e in events
            if str(e.device_type()).endswith("CUDA")
        ]
        ops.sort(key=lambda op: op[1])
        return DeviceTrace(ops, t0, t1)
