"""The port's counters and spans: one registry of counters, always on, and
spans that record while a ``torch.profiler`` session records.

Counters (:data:`COUNTERS`, a ``defaultdict(float)`` under one lock; the
marker search's ``protein_search.STATS`` is the same object). The keys
without a dot are the marker search's stage seconds, pairs and DP cells
(``protein_search``'s docstring); the dotted keys are counted once per
call or group where the work happens:

- ``prefilter.queries``, ``.hits`` (k-mer index entries read),
  ``.codes`` (expanded k-mer codes looked up), ``.candidates`` (double-hit
  diagonals scanned), ``.thread_s`` (the workers' seconds in their query
  groups, summed over threads), ``.slot_s`` (each call's wall times its
  thread count): ``native/prefilter.cpp``; the card's prefilter
  (``ops.prefilter``) counts the first four from counts made on the card,
  and has no thread seconds;
- ``search.groups``: query groups the marker search prefiltered;
  ``prefilter.card_groups``, ``prefilter.host_groups``: those prefiltered on
  a card and on the host;
- ``gene_calling.contigs``, ``.bp``: contigs and bases the gene caller
  called;
- ``crf.contigs``, ``crf.steps``: contigs the CRF scored and the gene
  positions its forward and backward loops stepped (2 x (T - 1) a batch
  padded to T genes);
- ``nn.windows``, ``nn.cache_bytes``: windows classified, bytes of the
  window caches written; ``nn.window_bp``: the contigs' bases that
  ``ops.nn_pipeline.encode_windows`` put into windows, before the N
  padding; ``nn.cache_chunks``: the deflate chunks each cache's ``bases``
  member was written in (1: one stream; ``utils.savez_compressed_threaded``);
- ``md5.bytes``: bytes hashed for the execution records;
- ``train.steps``, ``train.windows``, ``train.bp``: the trainer's steps,
  the windows its batches held and their bases before padding;
  ``train.nonfinite_losses``: steps whose loss was not finite, counted on
  the device and read once per ``train.Trainer.fit`` call.

Spans (:func:`span`): a name, the host's ``time.perf_counter`` at its start
and end (the clock a profiler's trace is mapped onto), the thread, the
enclosing span and the job. A job is the outermost span: ``end_to_end`` of
``cli.run_end_to_end``, or ``module.<name>`` of a module's ``main`` called
on its own. The trainer (``train.Trainer``) records ``train.batches`` (a
call's input) and, a step, ``train.step`` around ``train.forward``,
``train.backward`` and ``train.optimizer``; each of the two outer spans is
a job of its own. The enclosing span crosses threads through
``contextvars``: the port submits to its thread pools through
:func:`carry`. Spans record only
while a ``torch.profiler`` session records, on any thread (the profiler's
module-level flag); otherwise :func:`span` returns a shared no-op. Recorded
spans stay in a bounded buffer (:func:`spans`), so profiling a run with
``torch.profiler`` gives its stages on the trace's clock::

    with torch.profiler.profile(activities=[...]):
        cli.run_end_to_end(...)
    for s in trace.spans():
        print(s.name, s.job, s.t1 - s.t0)
"""

from __future__ import annotations

import contextvars
import functools
import itertools
import threading
import time
from collections import defaultdict, deque

import torch.autograd.profiler as _profiler

COUNTERS: defaultdict = defaultdict(float)
_COUNTERS_LOCK = threading.Lock()

BUFFER_SPANS = 1 << 16  # the newest spans kept
_BUFFER: deque = deque(maxlen=BUFFER_SPANS)
_BUFFER_LOCK = threading.Lock()
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("genomad_torch_span", default=None)
_SPAN_IDS = itertools.count(1)
_JOB_IDS = itertools.count(1)


def count(key: str, value: float) -> None:
    """COUNTERS[key] += value."""
    with _COUNTERS_LOCK:
        COUNTERS[key] += value


def count_many(values: dict) -> None:
    """Adds each of ``values`` to its key under one hold of the lock."""
    with _COUNTERS_LOCK:
        for key, value in values.items():
            COUNTERS[key] += value


class Span:
    """One recorded span. ``parent``: the enclosing span's ``id`` (None for
    a job's outermost span); ``thread``: ``threading.get_ident()``;
    ``attrs``: the keyword arguments given to :func:`span`."""

    __slots__ = ("name", "attrs", "id", "parent", "job", "thread", "t0", "t1", "_token")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        parent = _CURRENT.get()
        self.id = next(_SPAN_IDS)
        self.parent = parent.id if parent is not None else None
        self.job = parent.job if parent is not None else next(_JOB_IDS)
        self.thread = threading.get_ident()
        self._token = _CURRENT.set(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        _CURRENT.reset(self._token)
        self._token = None
        with _BUFFER_LOCK:
            _BUFFER.append(self)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A context manager that records ``name`` while a profiler records,
    and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return Span(name, attrs)


class timed:
    """A span that also adds its host-clock seconds to ``COUNTERS[key]``,
    whether spans record or not."""

    __slots__ = ("key", "_span", "_t0")

    def __init__(self, name: str, key: str, **attrs):
        self.key, self._span = key, span(name, **attrs)

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        count(self.key, time.perf_counter() - self._t0)
        return self._span.__exit__(*exc)


def spanned(name: str):
    """Decorates a function so that each call is the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def carry(fn):
    """``fn`` bound to a copy of the caller's context, so that spans opened
    where it runs (another thread) nest in the caller's open span. Copy at
    each submit: a context runs on one thread at a time."""
    return functools.partial(contextvars.copy_context().run, fn)


def spans() -> list:
    """The recorded spans in the order they ended (the newest
    ``BUFFER_SPANS``)."""
    with _BUFFER_LOCK:
        return list(_BUFFER)


def clear() -> None:
    """Forgets the recorded spans (the counters stay)."""
    with _BUFFER_LOCK:
        _BUFFER.clear()
