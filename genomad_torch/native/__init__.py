"""Native (C++) host-side components.

A copy of ``genomad_tpu/native`` with one change: the shared library is
compiled on first use with g++ (-O3 -march=native) into the port's
gitignored ``genomad_torch/build/``, not next to the source, and the build
is atomic (each process compiles to a private file and renames it), so
concurrent first uses never load a half-written library. Every native entry
point has a pure numpy fallback in genomad_torch.ops, so the package works
without a toolchain; the native path is selected automatically when
available. ``native_prefilter_batch.uses`` counts the calls the native
library served.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_LIB_PATH = _DIR.parent / "build" / "libgenomad_native.so"
_lib = None
_lib_failed = False


def _build() -> bool:
    sources = [str(_DIR / "prefilter.cpp")]
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", *sources, "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def get_library():
    """The loaded native library, or None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    newest_src = max(p.stat().st_mtime for p in _DIR.glob("*.cpp"))
    if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < newest_src:
        if not _build():
            _lib_failed = True
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        _lib_failed = True
        return None
    lib.prefilter_batch.restype = ctypes.c_int64
    lib.prefilter_batch.argtypes = [
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
    ]
    lib.prefilter_query.restype = ctypes.c_int64
    lib.prefilter_query.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # code_table (20^5+1 offsets)
        ctypes.POINTER(ctypes.c_int32),   # entry_pairs (interleaved)
        ctypes.c_int64,                   # n_profiles (stamp-table size)
        ctypes.POINTER(ctypes.c_int64),   # query_codes
        ctypes.c_int64,                   # n_codes
        ctypes.POINTER(ctypes.c_int8),    # residues
        ctypes.c_int64,                   # query_length
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
        ctypes.c_int64,                   # max_out
    ]
    _lib = lib
    return _lib


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
    over the max_out_per_query cap), or None when the native library is
    unavailable.
    """
    lib = get_library()
    if lib is None or not residues_list:
        return None
    from genomad_torch import utils
    from genomad_torch.ops.profiledb import encode_kmers

    if n_threads is None:
        n_threads = utils.get_n_available_cpus()
    codes_list = [np.ascontiguousarray(encode_kmers(r), np.int64) for r in residues_list]
    code_offsets = np.zeros(len(codes_list) + 1, np.int64)
    np.cumsum([len(c) for c in codes_list], out=code_offsets[1:])
    codes = np.concatenate(codes_list) if codes_list else np.zeros(0, np.int64)
    residue_offsets = np.zeros(len(residues_list) + 1, np.int64)
    np.cumsum([len(r) for r in residues_list], out=residue_offsets[1:])
    residues = np.ascontiguousarray(np.concatenate(residues_list), np.int8)
    codes = np.ascontiguousarray(codes, np.int64)
    code_table = np.ascontiguousarray(index.table, np.int32)
    entry_pairs = np.ascontiguousarray(index.pairs, np.int32)
    offsets = np.ascontiguousarray(db.offsets, np.int64)
    lengths = np.ascontiguousarray(db.lengths, np.int32)
    n_queries = len(residues_list)
    out = np.zeros((n_queries, max_out_per_query), np.int32)
    out_scores = np.zeros((n_queries, max_out_per_query), np.float32)
    counts = np.zeros(n_queries, np.int64)
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
    )
    written = np.minimum(counts, max_out_per_query)
    dropped = int((counts - written).sum())
    ids = [out[q, : written[q]].copy() for q in range(n_queries)]
    scores = [out_scores[q, : written[q]].copy() for q in range(n_queries)]
    native_prefilter_batch.uses += 1
    return ids, scores, dropped


native_prefilter_batch.uses = 0


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


def _bias_args(bias, keepalive: list):
    """(slack, bias pointer) ctypes args for comp-bias correction. The
    converted copy is appended to ``keepalive``, held by the caller for
    the duration of the C call (bias arrays are per-call, so a
    function-attribute pin would be overwritten by concurrent calls)."""
    if bias is None:
        return (0.0, ctypes.POINTER(ctypes.c_int32)())
    from genomad_torch.ops.blosum import COMP_BIAS_SLACK

    b = np.ascontiguousarray(bias, np.int32)
    keepalive.append(b)
    return (float(COMP_BIAS_SLACK), _ptr(b, ctypes.c_int32))


def _subst_args(kmer_thr: float | None, keepalive: list):
    """(subst pointer, threshold) ctypes args for the expansion mode."""
    if kmer_thr is None:
        return (ctypes.POINTER(ctypes.c_float)(), 1e30)
    from genomad_torch.ops.blosum import BLOSUM62

    subst = np.ascontiguousarray(BLOSUM62, np.float32)
    keepalive.append(subst)
    return (_ptr(subst, ctypes.c_float), float(kmer_thr))


def native_prefilter_query(
    index,
    residues,
    db,
    min_ungapped_score: float,
    max_out: int = 100_000,
    kmer_thr: float | None = None,
    bias=None,
):
    """Native prefilter (see prefilter.cpp). Returns (profile ids, ungapped
    scores) sorted by score descending, or None when the native library is
    unavailable. ``bias``: int32 comp-bias array (blosum.comp_bias)."""
    lib = get_library()
    if lib is None:
        return None
    from genomad_torch.ops.profiledb import encode_kmers

    keepalive: list = []
    codes = np.ascontiguousarray(encode_kmers(residues), np.int64)
    residues = np.ascontiguousarray(residues, np.int8)
    code_table = np.ascontiguousarray(index.table, np.int32)
    entry_pairs = np.ascontiguousarray(index.pairs, np.int32)
    offsets = np.ascontiguousarray(db.offsets, np.int64)
    lengths = np.ascontiguousarray(db.lengths, np.int32)
    out = np.zeros(max_out, np.int32)
    out_scores = np.zeros(max_out, np.float32)
    n = lib.prefilter_query(
        _ptr(code_table, ctypes.c_int32),
        _ptr(entry_pairs, ctypes.c_int32),
        int(db.n_profiles),
        _ptr(codes, ctypes.c_int64),
        len(codes),
        _ptr(residues, ctypes.c_int8),
        len(residues),
        _pssm_f32_arg(db, keepalive),
        _pssm8_arg(db),
        _ptr(offsets, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int32),
        float(min_ungapped_score),
        *_subst_args(kmer_thr, keepalive),
        *_bias_args(bias, keepalive),
        _ptr(out, ctypes.c_int32),
        _ptr(out_scores, ctypes.c_float),
        max_out,
    )
    n = min(n, max_out)
    del keepalive  # pinned through the C call above
    return out[:n].copy(), out_scores[:n].copy()
