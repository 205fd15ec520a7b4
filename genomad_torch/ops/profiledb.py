"""Packed protein-profile database for the search engine.

A copy of ``genomad_tpu/ops/profiledb.py``; formats and behaviour are
unchanged.

The reference delegates profile search to MMseqs2 over its own profile DB
format (genomad/mmseqs2.py:53-196, DB layout genomad/database.py:18-29).
Here profiles are position-specific scoring matrices (PSSMs) stored as
packed arrays, bucketed by length so the device-side search operates on
dense (n_profiles, L, 20) tensors:

  * names: (P,) marker names ("GENOMAD.xxxxx.xx")
  * lengths: (P,) int32
  * taxids: (P,) int32 (0 = no taxonomy)
  * pssm: float32 scores concatenated along positions, (total_positions, 20)
  * offsets: (P+1,) into pssm

Build paths:
  * from_arrays / save / load — native npz format
  * synthetic(seed) — deterministic random DB for tests/benchmarks
  * consensus k-mer index — the prefilter's inverted index, built with a
    counting sort over encoded k-mers (no Python dicts on the hot path)

Amino-acid alphabet: the 20 standard residues in the order below; unknown
residues map to index 20 and score 0 against every profile column.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
AA_INDEX = np.full(256, 20, dtype=np.int8)
for _i, _aa in enumerate(ALPHABET):
    AA_INDEX[ord(_aa)] = _i
    AA_INDEX[ord(_aa.lower())] = _i
N_AA = 20
KMER_K = 5


def _advise_hugepages(arr: np.ndarray) -> None:
    """madvise(MADV_HUGEPAGE) an array's pages. The prefilter's diagonal
    scans are random accesses into a ~1 GB PSSM: with this host's THP in
    'madvise' mode every 4 KB-paged candidate window pays a TLB page walk
    that software prefetch cannot hide; 2 MB pages make the whole buffer
    TLB-resident. Best-effort no-op off Linux or on failure."""
    import ctypes
    import ctypes.util
    import os
    import sys

    if (
        sys.platform != "linux"
        or arr.nbytes < (1 << 22)
        or os.environ.get("GENOMAD_NO_HUGEPAGES")
    ):
        return
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
        addr = arr.ctypes.data
        page = 1 << 21
        start = (addr + page - 1) & ~(page - 1)
        end = (addr + arr.nbytes) & ~(page - 1)
        if end > start:
            libc.madvise(
                ctypes.c_void_p(start),
                ctypes.c_size_t(end - start),
                ctypes.c_int(14),  # MADV_HUGEPAGE
            )
    except Exception:
        pass


def encode_protein(seq: str | bytes) -> np.ndarray:
    """Protein string -> int8 residue indices (20 = unknown/X)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return AA_INDEX[np.frombuffer(seq, dtype=np.uint8)]


def encode_kmers(residues: np.ndarray, k: int = KMER_K) -> np.ndarray:
    """Valid k-mer codes (base-20 packing) at each position; -1 where the
    window contains an unknown residue."""
    n = len(residues) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(residues, k)
    valid = (windows < N_AA).all(axis=1)
    weights = N_AA ** np.arange(k - 1, -1, -1, dtype=np.int64)
    codes = windows.astype(np.int64) @ weights
    return np.where(valid, codes, -1)


class ProfileDB:
    """Packed profile database.

    Fields: names (P,) unicode; lengths (P,) int32; taxids (P,) int32;
    pssm (total, 20) float32; offsets (P+1,) int64; ka_lambda/ka_k —
    Karlin-Altschul parameters fitted to THIS database's null score
    distribution (ops.statistics.calibrate_db); None = the generic
    BLOSUM62 fallback constants in ops.protein_search.

    ``pssm`` may be passed as a zero-arg callable: the f32 matrix then
    loads lazily on first access. The production cold path never touches
    it — the prefilter scans the int8 sidecar (pssm_i8) and device
    staging assembles buckets from the same int8 copy — so a disk-cached
    DB skips decompressing the multi-GB float PSSM entirely.
    """

    def __init__(self, names, lengths, taxids, pssm, offsets,
                 ka_lambda: float | None = None, ka_k: float | None = None):
        self.names = names
        self.lengths = lengths
        self.taxids = taxids
        self._pssm = pssm
        self.offsets = offsets
        self.ka_lambda = ka_lambda
        self.ka_k = ka_k
        self._kmer_index = None
        self._buckets = None
        # serializes the lazy f32 load and the int8-copy build: the
        # search's prestage thread and the prefilter thread both reach
        # pssm/pssm_i8 concurrently on the cold path, and an unlocked
        # double materialization of a multi-GB matrix risks OOM
        import threading

        self._pssm_lock = threading.RLock()  # reentrant: the int8 build holds it while reading .pssm

    @property
    def pssm(self) -> np.ndarray:
        if callable(self._pssm):
            with self._pssm_lock:
                if callable(self._pssm):
                    self._pssm = self._pssm()
        return self._pssm

    @pssm.setter
    def pssm(self, value) -> None:
        self._pssm = value

    @property
    def n_profiles(self) -> int:
        return len(self.names)

    @property
    def total_positions(self) -> int:
        return int(self.offsets[-1])

    def profile(self, i: int) -> np.ndarray:
        return self.pssm[self.offsets[i] : self.offsets[i + 1]]

    @property
    def pssm_i8(self) -> np.ndarray | None:
        """int8 copy of the PSSM when every score is integral and within
        [-127, 127]; None otherwise. Real MMseqs2/geNomad profile scores
        are small integers (the source format stores them as such), so
        production databases always qualify — the int8 copy drives the
        native prefilter's cache-compact diagonal scoring and gates bf16
        device staging (both are EXACT for integral values). Synthetic
        float test databases return None and keep full-f32 paths."""
        cached = self.__dict__.get("_pssm_i8_cache", False)
        if cached is not False:
            return cached
        with self._pssm_lock:
            return self._pssm_i8_locked()

    def _pssm_i8_locked(self):
        cached = self.__dict__.get("_pssm_i8_cache", False)
        if cached is not False:
            return cached
        size = self.total_positions * N_AA
        src = getattr(self, "_source_path", None)
        disk = src.with_name(src.name + ".i8.npy") if src is not None else None
        if (
            disk is not None
            and disk.exists()
            and disk.stat().st_mtime >= src.stat().st_mtime
        ):
            # sidecar hit: the lazy f32 PSSM is never materialized
            try:
                flat = np.load(disk, allow_pickle=False)
                if flat.dtype == np.int8 and flat.size == size + 64:
                    result = flat[:size].reshape(self.total_positions, N_AA)
                    _advise_hugepages(flat)
                    self.__dict__["_pssm_i8_cache"] = result
                    return result
                if flat.dtype == np.int8 and flat.size == 1:  # non-integral marker
                    self.__dict__["_pssm_i8_cache"] = None
                    return None
            except Exception:
                pass  # corrupt cache: recompute below
        p = self.pssm
        # chunked single-pass check: whole-array np.abs/np.trunc would
        # allocate ~2x the 4 GB production PSSM in temporaries and read it
        # three times; per-chunk temporaries stay cache-sized
        flat_view = p.reshape(-1)
        ok = True
        for s in range(0, flat_view.size, 1 << 22):
            c = flat_view[s : s + (1 << 22)]
            if not ((np.abs(c) <= 127.0) & (c == np.trunc(c))).all():
                ok = False
                break
        if ok:
            # 64 tail pad bytes: the native scan's 16-wide dword gathers
            # read up to 3 bytes past a score byte. madvise BEFORE
            # populating so the first touch faults hugepages in directly
            # (collapse-after-fill waits on khugepaged).
            flat = np.empty(p.size + 64, np.int8)
            _advise_hugepages(flat)
            flat[p.size :] = 0
            result = flat[: p.size].reshape(p.shape)
            np.copyto(result, p, casting="unsafe")
        else:
            flat = np.zeros(1, np.int8)  # marker: checked, non-integral
            result = None
        if disk is not None:
            try:  # best-effort disk cache (integrality check + copy cost
                # tens of seconds per cold process on a production PSSM)
                tmp = disk.with_suffix(".tmp.npy")
                np.save(tmp, flat)
                tmp.replace(disk)
            except Exception:
                pass
        self.__dict__["_pssm_i8_cache"] = result
        return result

    # -- persistence --------------------------------------------------------

    def save(self, path: Path) -> None:
        extra = {}
        if self.ka_lambda is not None:
            extra["ka_stats"] = np.array([self.ka_lambda, self.ka_k], np.float64)
        np.savez_compressed(
            path,
            names=self.names,
            lengths=self.lengths,
            taxids=self.taxids,
            pssm=self.pssm,
            offsets=self.offsets,
            **extra,
        )

    @classmethod
    def load(cls, path: Path) -> "ProfileDB":
        path = Path(path)

        def load_pssm() -> np.ndarray:
            with np.load(path, allow_pickle=False) as npz:
                return npz["pssm"].astype(np.float32)

        with np.load(path, allow_pickle=False) as npz:
            ka = npz["ka_stats"] if "ka_stats" in npz else (None, None)
            db = cls(
                names=npz["names"],
                lengths=npz["lengths"].astype(np.int32),
                taxids=npz["taxids"].astype(np.int32),
                # lazy: decompressing the multi-GB float PSSM costs ~a
                # minute at production scale and the int8/index sidecar
                # caches make it unnecessary on the hot path
                pssm=load_pssm,
                offsets=npz["offsets"].astype(np.int64),
                ka_lambda=None if ka[0] is None else float(ka[0]),
                ka_k=None if ka[1] is None else float(ka[1]),
            )
        db._source_path = path  # enables the on-disk sidecar caches
        return db

    @classmethod
    def from_profiles(cls, names, pssms, taxids=None) -> "ProfileDB":
        lengths = np.array([len(p) for p in pssms], dtype=np.int32)
        offsets = np.zeros(len(pssms) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        pssm = (
            np.concatenate([np.asarray(p, np.float32) for p in pssms])
            if len(pssms)
            else np.zeros((0, N_AA), np.float32)
        )
        if taxids is None:
            taxids = np.zeros(len(pssms), dtype=np.int32)
        return cls(np.asarray(names), lengths, np.asarray(taxids, np.int32), pssm, offsets)

    @classmethod
    def synthetic(
        cls,
        seed: int = 0,
        n_profiles: int = 64,
        min_len: int = 40,
        max_len: int = 300,
        residue_freqs=None,
        integral: bool = False,
    ) -> "ProfileDB":
        """Deterministic random DB: each profile strongly prefers one random
        'consensus' sequence (positive score on the consensus residue,
        negative elsewhere) — a realistic PSSM shape for testing.

        ``residue_freqs``: consensus residue distribution (default uniform;
        pass ops.statistics.BACKGROUND_FREQS for a composition-realistic DB
        — uniform consensus over-represents rare high-scoring residues like
        W/C, which inflates similar-k-mer list sizes ~25x vs real DBs).

        ``integral``: round scores to integers — the shape of REAL profile
        databases (MMseqs2/geNomad profiles store integer scores), which
        enables the exact int8 prefilter scan and bf16 device staging;
        benchmarks should pass True so they measure the production path."""
        rng = np.random.default_rng(seed)
        names, pssms = [], []
        taxids = rng.integers(0, 1000, n_profiles).astype(np.int32)
        for i in range(n_profiles):
            L = int(rng.integers(min_len, max_len + 1))
            if residue_freqs is None:  # keep the historical RNG stream
                consensus = rng.integers(0, N_AA, L)
            else:
                consensus = rng.choice(N_AA, L, p=residue_freqs)
            pssm = rng.normal(-2.0, 0.7, (L, N_AA)).astype(np.float32)
            pssm[np.arange(L), consensus] += rng.uniform(5.0, 9.0, L).astype(np.float32)
            if integral:
                pssm = np.round(pssm).astype(np.float32)
            names.append(f"GENOMAD.{i:06d}.XX")
            pssms.append(pssm)
        return cls.from_profiles(names, pssms, taxids)

    def consensus(self, i: int) -> np.ndarray:
        """Argmax residue per column of profile i."""
        return self.profile(i).argmax(1).astype(np.int8)

    # -- k-mer inverted index (prefilter) -----------------------------------

    def kmer_index(self, top_residues: int = 1):
        """Inverted index: k-mer code -> (profile, position) entries.

        DB-side sensitivity analog of MMseqs2's query-side similar-k-mer
        lists: with top_residues > 1, each profile column contributes its
        top-N residues and every combination over the k-window is indexed
        (N=1: consensus k-mers only; N=2 indexes up to 2^k = 32 k-mers per
        position). Cached per (top_residues).
        """
        if self._kmer_index is not None and self._kmer_index[0] == top_residues:
            return self._kmer_index[1]
        cache_path = self._index_cache_path(top_residues)
        if cache_path is not None and cache_path.exists():
            src = getattr(self, "_source_path", None)
            if src is None or cache_path.stat().st_mtime >= src.stat().st_mtime:
                try:
                    with np.load(cache_path, allow_pickle=False) as npz:
                        index = _KmerIndex.from_arrays(
                            npz["sorted_kmers"], npz["profiles"],
                            npz["positions"], npz["table"],
                        )
                    self._kmer_index = (top_residues, index)
                    return index
                except Exception:
                    pass  # corrupt/stale cache: rebuild below
        entries_kmers = []
        entries_profiles = []
        entries_positions = []
        for i in range(self.n_profiles):
            pssm = self.profile(i)
            L = len(pssm)
            if L < KMER_K:
                continue
            if top_residues == 1:
                residues = pssm.argmax(1).astype(np.int8)
                codes = encode_kmers(residues)
                pos = np.arange(len(codes))
                keep = codes >= 0
                entries_kmers.append(codes[keep])
                entries_profiles.append(np.full(keep.sum(), i, np.int32))
                entries_positions.append(pos[keep].astype(np.int32))
            else:
                top = np.argsort(pssm, axis=1)[:, -top_residues:]  # (L, N)
                n_pos = L - KMER_K + 1
                # combinations over the k window: N^k codes per position
                combo_codes = np.zeros((n_pos, 1), dtype=np.int64)
                for off in range(KMER_K):
                    col = top[off : off + n_pos]  # (n_pos, N)
                    combo_codes = (
                        combo_codes[:, :, None] * N_AA + col[:, None, :]
                    ).reshape(n_pos, -1)
                pos = np.repeat(np.arange(n_pos, dtype=np.int32), combo_codes.shape[1])
                codes = combo_codes.reshape(-1)
                entries_kmers.append(codes)
                entries_profiles.append(np.full(len(codes), i, np.int32))
                entries_positions.append(pos)
        if entries_kmers:
            kmers = np.concatenate(entries_kmers)
            profiles = np.concatenate(entries_profiles)
            positions = np.concatenate(entries_positions)
        else:
            kmers = np.zeros(0, np.int64)
            profiles = np.zeros(0, np.int32)
            positions = np.zeros(0, np.int32)
        order = np.argsort(kmers, kind="stable")
        sorted_kmers = kmers[order]
        # direct offset table over the full code space (20^5 + 1 entries):
        # entry range of code c is [table[c], table[c+1]) — O(1) lookup, no
        # binary search, which is what makes query-side similar-k-mer
        # expansion affordable (each expanded k-mer costs one load)
        n_codes = N_AA**KMER_K
        table = np.zeros(n_codes + 1, np.int32)  # int32: halves the random-
        # access footprint in the native DFS (entry counts are << 2^31)
        np.cumsum(np.bincount(sorted_kmers, minlength=n_codes), out=table[1:])
        index = _KmerIndex.from_arrays(
            sorted_kmers, profiles[order], positions[order], table
        )
        self._kmer_index = (top_residues, index)
        if cache_path is not None:
            try:  # best-effort: the index rebuild is always available
                tmp = cache_path.with_suffix(".tmp.npz")
                np.savez(
                    tmp,
                    sorted_kmers=index.sorted_kmers,
                    profiles=index.profiles,
                    positions=index.positions,
                    table=index.table,
                )
                tmp.replace(cache_path)
            except Exception:
                pass
        return index

    def _index_cache_path(self, top_residues: int) -> Path | None:
        """On-disk cache path for the k-mer inverted index: the production
        (227k-profile) index takes ~50 s of argsort per process to build,
        vs a few seconds to reload (~850 MB uncompressed). Only available
        when the DB itself was loaded from disk."""
        src = getattr(self, "_source_path", None)
        if src is None:
            return None
        return src.with_name(src.name + f".kidx{top_residues}.npz")

    # -- length bucketing (device layout) -----------------------------------

    def buckets(self, boundaries=(64, 128, 256, 512, 1024, 4096)):
        """Group profiles into padded dense tensors by length class.

        Returns a list of dicts: {profile_ids (n,), padded (n, L, 20),
        lengths (n,)} with pad columns scored 0 (neutral).
        """
        if self._buckets is not None:
            return self._buckets
        out = []
        for b_i, bound in enumerate(boundaries):
            lo = 0 if b_i == 0 else boundaries[b_i - 1]
            ids = np.where((self.lengths > lo) & (self.lengths <= bound))[0]
            if not len(ids):
                continue
            padded = np.zeros((len(ids), bound, N_AA), np.float32)
            for j, pid in enumerate(ids):
                padded[j, : self.lengths[pid]] = self.profile(pid)
            out.append(
                {
                    "profile_ids": ids.astype(np.int32),
                    "padded": padded,
                    "lengths": self.lengths[ids].astype(np.int32),
                }
            )
        self._buckets = out
        return out

    def shard(self, n_shards: int, shard_index: int) -> "ProfileDB":
        """Contiguous shard of the DB (device-side DB parallelism)."""
        ids = np.arange(self.n_profiles)[shard_index::n_shards]
        out = ProfileDB.from_profiles(
            self.names[ids],
            [self.profile(i) for i in ids],
            self.taxids[ids],
        )
        # statistics are a whole-DB property: shards must score identically
        out.ka_lambda, out.ka_k = self.ka_lambda, self.ka_k
        return out


@dataclass
class _KmerIndex:
    sorted_kmers: np.ndarray  # (E,) int64, ascending
    profiles: np.ndarray  # (E,) int32 (strided view into ``pairs``)
    positions: np.ndarray  # (E,) int32 (strided view into ``pairs``)
    table: np.ndarray  # (20^k + 1,) int64 direct offset table
    # (2E,) int32 INTERLEAVED [profile, position] entries: the native
    # prefilter's per-hit loop touches one contiguous stream (and one
    # cache line per entry) instead of two parallel arrays; profiles/
    # positions above are zero-copy strided views for the numpy paths.
    pairs: np.ndarray

    @classmethod
    def from_arrays(cls, sorted_kmers, profiles, positions, table):
        pairs = np.empty(2 * len(profiles), np.int32)
        pairs[0::2] = profiles
        pairs[1::2] = positions
        return cls(
            sorted_kmers=sorted_kmers,
            profiles=pairs[0::2],
            positions=pairs[1::2],
            table=table,
            pairs=pairs,
        )

    def lookup(self, codes: np.ndarray):
        """For each query k-mer code, the range of matching entries.

        Returns (starts, ends) arrays aligned with ``codes``.
        """
        return self.table[codes], self.table[codes + 1]
