"""The marker search's prefilter on the card: the hand-written kernels of
``genomad_torch/csrc/prefilter.cu`` behind :func:`card_prefilter_batch`.

It takes the arguments of ``native.native_prefilter_batch`` (the C++
prefilter, ``native/prefilter.cpp``) and gives its results bit for bit:
each query's candidate ids and ungapped scores, score descending and id
ascending, and the count dropped over ``max_out_per_query``. The C++ is
this route's plain version: a search on the CPU runs it, and the card tests
(``tests/test_torch_prefilter_card.py``) hold these kernels to it. On a
card the route launches its kernels or raises; nothing falls back. The
similar-k-mer tables and the extension window come from the C++ library
itself (``native.expansion_tables``, ``native.prefilter_window``), so both
routes expand and scan alike.

The DB's index (``code_table``, the interleaved entries), its offsets,
lengths and PSSM (the int8 copy where the scores are integral, else f32) go
to the card once per DB object and device (:func:`_staged_db`); the tables
once per threshold. A call runs on a CUDA stream of its own, so the
search's K1 launches on the search thread's stream overlap it, and waits
only on that stream, inside two C calls that release the GIL (the search
thread keeps it for its own host work): one for the per-position counts,
one that runs the slices of at most ``Q_SLICE`` queries and about
``HIT_SLICE`` index hits back to back, then copies the group's selected
counts and lists back.

It counts ``prefilter.queries``, ``.hits``, ``.codes`` and ``.candidates``
from counts made on the card (``genomad_torch.trace``), as the C++ does;
``prefilter.thread_s`` and ``.slot_s`` are the host workers' and stay
still. ``card_prefilter_batch.launches`` counts the calls that launched the
kernels.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from genomad_torch import native, trace
from genomad_torch.ops import _build
from genomad_torch.ops.profiledb import KMER_K

Q_SLICE = 32  # queries a slice: its (query, profile) counters, best scores and sort scratch
HIT_SLICE = 1 << 26  # index hits a slice (12 bytes each), unless one query alone holds more

_P = _build.P
_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)
_EXPANSION = [_P] * 6 + [ctypes.POINTER(_P), _build.I, _build.F, _build.F]
_SIGNATURES = {
    "prefilter_arena_bytes": [_I64] * 6 + [_I64P],
    "prefilter_count_run": _EXPANSION + [_I64, _P, _P, _P],
    "prefilter_slices_run": _EXPANSION[:6] + [_P] + _EXPANSION[6:] + [_P] * 4
    + [_I64, _I64, _build.F, _I64, _P, _P, _I64, _P] + [_I64] * 5 + [_P] * 6,
}

_lock = threading.Lock()
_streams: dict = {}
_tables: dict = {}


def _stream(device) -> torch.cuda.Stream:
    with _lock:
        stream = _streams.get(str(device))
        if stream is None:
            stream = _streams[str(device)] = torch.cuda.Stream(device)
        return stream


def _up(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)


def _staged_db(db, index, device) -> dict:
    """The DB's prefilter operands on ``device``, uploaded once per DB object
    (on the prefilter's stream, synchronized before they are cached)."""
    cache = db.__dict__.setdefault("_torch_prefilter", {})
    key = str(device)
    with db.__dict__.setdefault("_torch_prefilter_lock", threading.Lock()):
        staged = cache.get(key)
        if staged is None:
            pssm8 = db.pssm_i8
            staged = {
                "code_table": _up(np.asarray(index.table, np.int32), device),
                "pairs": _up(np.asarray(index.pairs, np.int32), device),
                "offsets": _up(np.asarray(db.offsets, np.int64), device),
                "lengths": _up(np.asarray(db.lengths, np.int32), device),
                "pssm8": _up(pssm8.reshape(-1), device) if pssm8 is not None else None,
                "pssm": _up(np.asarray(db.pssm, np.float32).reshape(-1), device) if pssm8 is None else None,
            }
            torch.cuda.current_stream(device).synchronize()
            cache[key] = staged
        return staged


_TABLE_KEYS = ("l2_off", "l2_code", "l2_score", "l3_off", "l3_code", "l3_score")


def _staged_tables(kmer_thr: float, slack: float, device) -> tuple:
    """(the six product tables on ``device``, their f32 threshold), once per
    (device, threshold, slack)."""
    key = (str(device), float(np.float32(kmer_thr)), float(slack))
    with _lock:
        staged = _tables.get(key)
        if staged is None:
            host = native.expansion_tables(kmer_thr, slack)
            staged = ([_up(host[k], device) for k in _TABLE_KEYS], host["thr"])
            torch.cuda.current_stream(device).synchronize()
            _tables[key] = staged
        return staged


def _slices(q_hits: np.ndarray):
    """[start, end) query ranges of at most Q_SLICE queries and about
    HIT_SLICE hits (a query over that alone is a slice of its own)."""
    start, n = 0, len(q_hits)
    while start < n:
        end, hits = start + 1, int(q_hits[start])
        while end < n and end - start < Q_SLICE and hits + int(q_hits[end]) <= HIT_SLICE:
            hits += int(q_hits[end])
            end += 1
        yield start, end
        start = end


def card_prefilter_batch(
    index,
    residues_list,
    db,
    min_ungapped_score: float,
    max_out_per_query: int = 8_192,
    kmer_thr: float | None = None,
    bias_list=None,
    device=None,
):
    """``native.native_prefilter_batch``'s results, computed on the CUDA
    ``device``: (per-query candidate id arrays, per-query score arrays in the
    same order, total dropped over ``max_out_per_query``); empty lists and 0
    for no queries, with nothing launched."""
    if not residues_list:
        return [], [], 0
    device = torch.device(device)
    lib = _build.load("prefilter", _SIGNATURES)
    nq, P = len(residues_list), int(db.n_profiles)
    lengths = np.array([len(r) for r in residues_list], np.int64)
    roff = np.zeros(nq + 1, np.int64)
    np.cumsum(lengths, out=roff[1:])
    n_codes = np.maximum(lengths - (KMER_K - 1), 0)  # the query's 5-mer positions
    code_off = np.zeros(nq + 1, np.int64)
    np.cumsum(n_codes, out=code_off[1:])
    n_pos = int(code_off[-1])
    pos_g = np.repeat(np.arange(nq, dtype=np.int32), n_codes)
    pos_q = (np.arange(n_pos, dtype=np.int64) - np.repeat(code_off[:-1], n_codes)).astype(np.int32)
    residues = np.concatenate(residues_list).astype(np.int8)
    expand = kmer_thr is not None
    if bias_list is not None:
        from genomad_torch.ops.blosum import COMP_BIAS_SLACK

        bias, slack = np.concatenate(bias_list).astype(np.int32), float(COMP_BIAS_SLACK)
        assert len(bias) == roff[-1]
    else:
        bias, slack = None, 0.0
    window = native.prefilter_window()
    stride = min(P, int(max_out_per_query))  # a query's list holds at most this
    stream = _stream(device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(device), torch.cuda.stream(stream):
        s = _build.stream_ptr(device)
        dbt = _staged_db(db, index, device)
        if expand:
            tables, thr = _staged_tables(kmer_thr, slack, device)
            thr_nominal = np.float32(kmer_thr)
            bias_slack = float(np.float32(thr_nominal - thr))
        else:
            tables, thr_nominal, bias_slack = [None] * 6, np.float32(0.0), 0.0
        table_ptrs = (_P * 6)(*(ptr(t) for t in tables))
        residues_t, pos_q_t, pos_g_t, roff_t = (_up(a, device) for a in (residues, pos_q, pos_g, roff))
        bias_t = _up(bias, device) if bias is not None else None
        expansion = (ptr(residues_t), ptr(pos_q_t), ptr(pos_g_t), ptr(roff_t), ptr(bias_t), ptr(dbt["code_table"]),
                     table_ptrs, int(expand), float(thr_nominal), bias_slack)
        counts = np.zeros(3 * n_pos, np.int64)
        dev_counts = torch.empty(3 * n_pos, dtype=torch.int64, device=device)
        _build.check(lib.prefilter_count_run(*expansion, n_pos, ptr(dev_counts), counts.ctypes.data, s),
                     "card prefilter (counts)")
        lookups, nz, hits = counts.reshape(3, n_pos)
        exp_off = np.zeros(n_pos + 1, np.int64)
        np.cumsum(nz, out=exp_off[1:])
        hit_off = np.zeros(n_pos + 1, np.int64)
        np.cumsum(hits, out=hit_off[1:])
        q_hits = hit_off[code_off[1:]] - hit_off[code_off[:-1]]
        bounds = np.array(list(_slices(q_hits)), np.int64)
        pa, pb = code_off[bounds[:, 0]], code_off[bounds[:, 1]]
        E, H = exp_off[pb] - exp_off[pa], hit_off[pb] - hit_off[pa]
        if H.max() >= 1 << 32:
            raise ValueError(f"card prefilter: one slice has {int(H.max())} index hits, more than 2^32")
        slices = np.ascontiguousarray(np.column_stack([bounds, pa, pb, E, H]))
        # a query selects at most its hits' profiles and at most `stride`
        out_cap = max(1, int(np.minimum(q_hits, stride).sum()))
        sizes = (int(E.max()), int(H.max()), int((bounds[:, 1] - bounds[:, 0]).max()), P, nq, out_cap)
        arena_bytes = ctypes.c_int64(0)
        lib.prefilter_arena_bytes(*sizes, ctypes.byref(arena_bytes))
        arena = torch.empty(arena_bytes.value, dtype=torch.uint8, device=device)
        offsets_t = _up(np.concatenate([exp_off, hit_off]), device)
        sel = np.zeros(nq, np.int64)
        out_ids = np.empty(out_cap, np.int32)  # only the lists' pages are touched
        out_scores = np.empty(out_cap, np.float32)
        n_cand = np.zeros(1, np.int64)
        _build.check(lib.prefilter_slices_run(
            *expansion[:6], ptr(dbt["pairs"]), *expansion[6:], ptr(dbt["pssm8"]), ptr(dbt["pssm"]),
            ptr(dbt["offsets"]), ptr(dbt["lengths"]), P, window, float(min_ungapped_score), int(max_out_per_query),
            ptr(offsets_t), ptr(offsets_t) + 8 * (n_pos + 1), len(slices), slices.ctypes.data, *sizes[:3], nq,
            out_cap, ptr(arena), sel.ctypes.data, out_ids.ctypes.data, out_scores.ctypes.data, n_cand.ctypes.data, s,
        ), "card prefilter (slices)")
    written = np.minimum(sel, max_out_per_query)
    at = np.zeros(nq + 1, np.int64)
    np.cumsum(written, out=at[1:])
    trace.count_many({
        "prefilter.queries": nq,
        "prefilter.hits": float(hits.sum()),
        "prefilter.codes": float(lookups.sum()),
        "prefilter.candidates": float(n_cand[0]),
    })
    card_prefilter_batch.launches += 1
    return ([out_ids[at[q] : at[q + 1]] for q in range(nq)], [out_scores[at[q] : at[q + 1]] for q in range(nq)],
            int((sel - written).sum()))


card_prefilter_batch.launches = 0
