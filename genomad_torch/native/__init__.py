"""The marker search's prefilter on the host: the C++ library ``prefilter.cpp``.

A search on the CPU prefilters here; a search on a card runs the kernels of
``csrc/prefilter.cu`` (``ops.prefilter``), which give this library's lists
bit for bit and take their k-mer tables and window from it
(:func:`expansion_tables`, :func:`prefilter_window`): this library is their
plain version and their tests' oracle. It is compiled at first use with ``g++``
(``_GXX_FLAGS``) through ``genomad_torch.build_dir``, as the kernels are
with ``nvcc``, into the port's build dir under a name that hashes the
source and the flags. A host without a C++ compiler gets the compiler's
error, not a slower path. The algorithm is stated in NumPy by the JAX
package's ``genomad_tpu/ops/protein_search.py`` (``prefilter_query``),
which the tests hold the search to.

``prefilter_batch`` returns its own counts (queries, index hits, expanded
codes, candidates, the workers' seconds and the call's thread slots)
through an out-array on every call. ``native_prefilter_batch.uses`` counts
the calls the library served; each call adds those counts to the port's
counters (``genomad_torch.trace``, ``prefilter.*``).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from genomad_torch import trace
from genomad_torch.build_dir import compile_library, load_library

_SOURCES = sorted(Path(__file__).parent.glob("*.cpp"))
_CXX = "g++"
_GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_SIGNATURE = [
    ctypes.POINTER(ctypes.c_int32),   # code_table (20^5+1 offsets)
    ctypes.POINTER(ctypes.c_int32),   # entry_pairs (interleaved)
    ctypes.c_int64,                   # n_profiles (stamp-table size)
    ctypes.POINTER(ctypes.c_int64),   # query_codes (concat)
    ctypes.POINTER(ctypes.c_int64),   # code_offsets
    ctypes.POINTER(ctypes.c_int8),    # residues (concat)
    ctypes.POINTER(ctypes.c_int64),   # residue_offsets
    ctypes.c_int64,                   # n_queries
    ctypes.POINTER(ctypes.c_float),   # pssm
    ctypes.POINTER(ctypes.c_int8),    # pssm8 (NULL = f32 scan)
    ctypes.POINTER(ctypes.c_int64),   # offsets
    ctypes.POINTER(ctypes.c_int32),   # lengths
    ctypes.c_float,                   # min_ungapped_score
    ctypes.POINTER(ctypes.c_float),   # subst (20x20; NULL = exact only)
    ctypes.c_float,                   # kmer_thr
    ctypes.c_float,                   # kmer_slack (tables at thr-slack)
    ctypes.POINTER(ctypes.c_int32),   # comp-bias ints (NULL = off)
    ctypes.POINTER(ctypes.c_int32),   # out_profiles
    ctypes.POINTER(ctypes.c_float),   # out_scores (NULL = discard)
    ctypes.POINTER(ctypes.c_int64),   # out_counts (uncapped totals)
    ctypes.c_int64,                   # max_out_per_query
    ctypes.c_int32,                   # n_threads
    ctypes.POINTER(ctypes.c_double),  # out_work (6)
]
_TABLES_SIGNATURE = [
    ctypes.POINTER(ctypes.c_float),   # subst (20x20)
    ctypes.c_float,                   # kmer_thr
    ctypes.c_float,                   # kmer_slack
    ctypes.POINTER(ctypes.c_int64),   # sizes (2): l2, l3 entries
    ctypes.POINTER(ctypes.c_float),   # the tables' threshold
    ctypes.POINTER(ctypes.c_int64),   # l2_off (401; NULL = sizes only)
    ctypes.POINTER(ctypes.c_int32),   # l2_code
    ctypes.POINTER(ctypes.c_float),   # l2_score
    ctypes.POINTER(ctypes.c_int64),   # l3_off (8001)
    ctypes.POINTER(ctypes.c_int32),   # l3_code
    ctypes.POINTER(ctypes.c_float),   # l3_score
]


@functools.cache
def library() -> ctypes.CDLL:
    """The prefilter's library, built if needed; raises ``RuntimeError``
    with the compiler's output when it cannot be built."""
    path, _ = compile_library("genomad_native", _CXX, _SOURCES, _GXX_FLAGS)
    return load_library(path, {"prefilter_batch": _SIGNATURE, "prefilter_tables": _TABLES_SIGNATURE,
                               "prefilter_window": []}, restype=ctypes.c_int64)


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def native_prefilter_batch(
    index,
    residues_list,
    db,
    min_ungapped_score: float,
    max_out_per_query: int = 8_192,
    n_threads: int | None = None,
    kmer_thr: float | None = None,
    bias_list=None,
):
    """Multithreaded batch prefilter over all queries at once.

    ``kmer_thr``: BLOSUM62 similar-k-mer score threshold for query-side
    k-mer expansion (ops.blosum.kmer_score_threshold); None = exact k-mers.
    ``bias_list``: per-query int32 composition-bias arrays
    (blosum.comp_bias) applied to diagonal scores and expansion
    thresholds (MMseqs2 --comp-bias-corr 1); None = off.

    Returns (per-query candidate id arrays sorted by ungapped score
    descending, per-query score arrays in the same order, total dropped
    over the max_out_per_query cap); empty lists and 0 for no queries.
    Raises ``RuntimeError`` when the library cannot be built. Counts
    ``prefilter.queries``, ``.hits``, ``.codes``, ``.candidates``,
    ``.thread_s`` and ``.slot_s`` (``genomad_torch.trace``).
    """
    if not residues_list:
        return [], [], 0
    lib = library()
    from genomad_torch import utils
    from genomad_torch.ops.profiledb import encode_kmers

    if n_threads is None:
        n_threads = utils.get_n_available_cpus()
    codes_list = [np.ascontiguousarray(encode_kmers(r), np.int64) for r in residues_list]
    code_offsets = np.zeros(len(codes_list) + 1, np.int64)
    np.cumsum([len(c) for c in codes_list], out=code_offsets[1:])
    codes = np.concatenate(codes_list)
    residue_offsets = np.zeros(len(residues_list) + 1, np.int64)
    np.cumsum([len(r) for r in residues_list], out=residue_offsets[1:])
    residues = np.ascontiguousarray(np.concatenate(residues_list), np.int8)
    code_table = np.ascontiguousarray(index.table, np.int32)
    entry_pairs = np.ascontiguousarray(index.pairs, np.int32)
    offsets = np.ascontiguousarray(db.offsets, np.int64)
    lengths = np.ascontiguousarray(db.lengths, np.int32)
    n_queries = len(residues_list)
    out = np.zeros((n_queries, max_out_per_query), np.int32)
    out_scores = np.zeros((n_queries, max_out_per_query), np.float32)
    counts = np.zeros(n_queries, np.int64)
    work = np.zeros(len(WORK_KEYS), np.float64)
    keepalive: list = []
    if bias_list is not None:
        bias_all = np.ascontiguousarray(np.concatenate(bias_list), np.int32)
        assert len(bias_all) == residue_offsets[-1]
        keepalive.append(bias_all)
        bias_arg = _ptr(bias_all, ctypes.c_int32)
        from genomad_torch.ops.blosum import COMP_BIAS_SLACK

        slack = float(COMP_BIAS_SLACK)
    else:
        bias_arg = ctypes.POINTER(ctypes.c_int32)()
        slack = 0.0
    lib.prefilter_batch(
        _ptr(code_table, ctypes.c_int32),
        _ptr(entry_pairs, ctypes.c_int32),
        int(db.n_profiles),
        _ptr(codes, ctypes.c_int64),
        _ptr(code_offsets, ctypes.c_int64),
        _ptr(residues, ctypes.c_int8),
        _ptr(residue_offsets, ctypes.c_int64),
        n_queries,
        _pssm_f32_arg(db, keepalive),
        _pssm8_arg(db),
        _ptr(offsets, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int32),
        float(min_ungapped_score),
        *_subst_args(kmer_thr, keepalive),
        slack,
        bias_arg,
        _ptr(out, ctypes.c_int32),
        _ptr(out_scores, ctypes.c_float),
        _ptr(counts, ctypes.c_int64),
        max_out_per_query,
        int(n_threads),
        _ptr(work, ctypes.c_double),
    )
    trace.count_many(dict(zip(WORK_KEYS, work.tolist())))
    written = np.minimum(counts, max_out_per_query)
    dropped = int((counts - written).sum())
    ids = [out[q, : written[q]].copy() for q in range(n_queries)]
    scores = [out_scores[q, : written[q]].copy() for q in range(n_queries)]
    native_prefilter_batch.uses += 1
    return ids, scores, dropped


native_prefilter_batch.uses = 0

# prefilter_batch's out_work, in order
WORK_KEYS = ("prefilter.queries", "prefilter.hits", "prefilter.codes", "prefilter.candidates",
             "prefilter.thread_s", "prefilter.slot_s")


def _pssm_f32_arg(db, keepalive: list):
    """f32-PSSM ctypes arg — NULL when the int8 copy is active (the C scan
    then never dereferences the f32 matrix, so the lazy multi-GB float
    PSSM is never materialized on the production path). Any converted
    copy is appended to ``keepalive``, which the caller holds for the
    duration of the C call (a function-attribute pin would be overwritten
    by a concurrent call on another DB — use-after-free)."""
    if db.pssm_i8 is not None:
        return ctypes.POINTER(ctypes.c_float)()
    pssm = np.ascontiguousarray(db.pssm, np.float32)
    keepalive.append(pssm)
    return _ptr(pssm, ctypes.c_float)


def _pssm8_arg(db):
    """int8-PSSM ctypes arg: the cached integral int8 copy when the DB's
    scores are integral (db.pssm_i8 — real profile scores always are),
    else NULL (C side falls back to the f32 scan). The int8 scan is
    bit-equal for integral values at 4x less memory traffic."""
    p8 = db.pssm_i8
    if p8 is None:
        return ctypes.POINTER(ctypes.c_int8)()
    return _ptr(p8, ctypes.c_int8)


def _subst_args(kmer_thr: float | None, keepalive: list):
    """(subst pointer, threshold) ctypes args for the expansion mode."""
    if kmer_thr is None:
        return (ctypes.POINTER(ctypes.c_float)(), 1e30)
    from genomad_torch.ops.blosum import BLOSUM62

    subst = np.ascontiguousarray(BLOSUM62, np.float32)
    keepalive.append(subst)
    return (_ptr(subst, ctypes.c_float), float(kmer_thr))


def expansion_tables(kmer_thr: float, slack: float) -> dict:
    """The similar-k-mer product tables ``prefilter_batch`` expands with at
    ``kmer_thr`` (built at ``kmer_thr - slack``): ``l2_off`` (401,),
    ``l2_code``, ``l2_score`` and ``l3_off`` (8001,), ``l3_code``,
    ``l3_score`` (int64 offsets, int32 codes, f32 scores, each list sorted
    by score descending, code ascending), and ``thr``, the f32 threshold
    they were built at. The card prefilter expands from these, so both
    routes list the same k-mers in the same order."""
    lib = library()
    keepalive: list = []
    subst, thr = _subst_args(kmer_thr, keepalive)
    sizes = np.zeros(2, np.int64)
    built = ctypes.c_float(0.0)
    null = [ctypes.POINTER(t)() for t in (ctypes.c_int64, ctypes.c_int32, ctypes.c_float)] * 2
    lib.prefilter_tables(subst, thr, float(slack), _ptr(sizes, ctypes.c_int64), ctypes.byref(built), *null)
    out = {
        "l2_off": np.zeros(401, np.int64), "l2_code": np.zeros(sizes[0], np.int32), "l2_score": np.zeros(sizes[0], np.float32),
        "l3_off": np.zeros(8001, np.int64), "l3_code": np.zeros(sizes[1], np.int32), "l3_score": np.zeros(sizes[1], np.float32),
    }
    ctypes_of = {np.int64: ctypes.c_int64, np.int32: ctypes.c_int32, np.float32: ctypes.c_float}
    arrays = [_ptr(out[k], ctypes_of[out[k].dtype.type]) for k in ("l2_off", "l2_code", "l2_score", "l3_off", "l3_code", "l3_score")]
    lib.prefilter_tables(subst, thr, float(slack), _ptr(sizes, ctypes.c_int64), ctypes.byref(built), *arrays)
    out["thr"] = np.float32(built.value)
    return out


def prefilter_window() -> int:
    """The extension half-window ``prefilter_batch`` scans with: the C++'s
    own parse of ``GENOMAD_PREFILTER_WINDOW`` (16 when unset, 2^40, the
    whole diagonal, at 0 or below)."""
    return int(library().prefilter_window())
