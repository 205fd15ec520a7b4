"""tRNA detection (ARAGORN functional analog).

The reference shells out to the ARAGORN C binary with ``-l -ps105 -w``
(genomad/aragorn.py:19-32) and parses ``tRNA-Xxx c[start,end]`` records into
``<contig>_tRNA<i>_<aa>\\tstart\\tend`` rows (aragorn.py:34-54). tRNA
coordinates only feed provirus boundary refinement (max 5 kb extension,
find_proviruses.py:675-683).

This module implements a structure-anchored cloverleaf detector:

  * anchor: the T-loop TTC motif (T54-Psi55-C56 of the canonical fold);
  * from the anchor, fixed-geometry 3' arm (T-stem 5 bp, acceptor stem 7 bp,
    discriminator) and variable-geometry 5' arm (D-loop + variable-loop
    slack, wide enough for type II long-variable-arm tRNAs) are scored by
    Watson-Crick/GU base-pairing in all FOUR stems (21 pairable positions:
    acceptor 7 + D 4 + anticodon 5 + T 5), each with a per-stem minimum;
  * candidates are scored on ARAGORN's reporting scale: Watson-Crick pairs
    score 2, GU wobble pairs 1, plus conserved-base bonuses (anchored
    T-loop, U33, purine-37), scaled so a canonical fully-paired gene lands
    at ~120 points and ARAGORN's default acceptance threshold corresponds
    to 100 points. ``-psN`` then means exactly what it means in ARAGORN —
    the cutoff moves to N% of the default threshold, i.e. N points
    (genomad passes ``-ps105`` -> accept at 105; aragorn.py:13-17) —
    instead of round 2's guessed linear rescale of a pair-count.
    Sensitivity 1.00 on architecture-generated type I+II genes, >= 0.9
    with realistic GU-wobble stems, ~1 false call per 200 kb of random DNA
    (tests/test_trna.py). The absolute point scale could not be verified
    against an ARAGORN binary here (none installed, no network);
    tools/trna_vs_aragorn.py runs the comparison automatically wherever
    one exists.

Output rows match the reference's parsed format exactly.

A copy of ``genomad_tpu/ops/trna.py`` (host).
"""

from __future__ import annotations

from pathlib import Path

from genomad_torch import sequence as seqlib

_WC = {("A", "T"), ("T", "A"), ("G", "C"), ("C", "G")}
_GU = {("G", "T"), ("T", "G")}
_PAIRS = _WC | _GU

_AA3 = {
    "A": "Ala", "R": "Arg", "N": "Asn", "D": "Asp", "C": "Cys", "Q": "Gln",
    "E": "Glu", "G": "Gly", "H": "His", "I": "Ile", "L": "Leu", "K": "Lys",
    "M": "Met", "F": "Phe", "P": "Pro", "S": "Ser", "T": "Thr", "W": "Trp",
    "Y": "Tyr", "V": "Val", "*": "SeC", "X": "Pyl",
}

# ARAGORN-scale scoring: default acceptance threshold = 100 points;
# geNomad's -ps105 accepts at 105 (genomad/aragorn.py:13-17).
DEFAULT_THRESHOLD = 105.0
_SCALE = 2.5  # points per raw unit: perfect type I = (42 + 6) * 2.5 = 120


def _n_pairs(a: str, b_reversed: str) -> int:
    return sum((x, y) in _PAIRS for x, y in zip(a, b_reversed[::-1]))


def _pair_points(a: str, b_reversed: str) -> float:
    """Raw pairing quality of a stem: WC = 2, GU wobble = 1, mismatch = 0."""
    total = 0.0
    for x, y in zip(a, b_reversed[::-1]):
        if (x, y) in _WC:
            total += 2.0
        elif (x, y) in _GU:
            total += 1.0
    return total


def _anticodon_to_aa(anticodon: str) -> str:
    from genomad_torch.ops.gene_calling import translate

    codon = seqlib.Sequence("x", anticodon).rc().seq
    aa = translate(codon, 11)
    return _AA3.get(aa, "Und")


def _scan_strand(seq: str, min_score: float = DEFAULT_THRESHOLD):
    """Yield (start0, end0_inclusive, score, aa) candidate tRNAs on the
    given strand; ``score`` is in ARAGORN points (see module docstring).

    Geometry ranges cover both tRNA classes: the 5' arm search reaches 65
    nt upstream of the T-loop anchor so type II tRNAs (Leu/Ser/SeC, long
    variable arms of ~10-16 nt) are inside the window, and the anticodon
    arm offset spans D-loops of 7-13 nt."""
    n = len(seq)
    m = seq.find("TTC")
    while m != -1:
        best = None
        if m >= 46 and m + 19 < n:
            t_stem = _n_pairs(seq[m - 5 : m], seq[m + 7 : m + 12])
            if t_stem >= 4:
                t_pts = _pair_points(seq[m - 5 : m], seq[m + 7 : m + 12])
                acc3 = seq[m + 12 : m + 19]
                for start in range(m - 65, m - 45):
                    if start < 0:
                        continue
                    acc5 = seq[start : start + 7]
                    if _n_pairs(acc5, acc3) < 6:
                        continue
                    acc_pts = _pair_points(acc5, acc3)
                    # anticodon arm: stem 5 bp + loop 7 nt + stem 5 bp
                    for q in range(start + 21, start + 31):
                        ac5 = seq[q : q + 5]
                        ac3 = seq[q + 12 : q + 17]
                        if _n_pairs(ac5, ac3) < 4:
                            continue
                        # D-stem: 4 bp after acceptor+spacer, closing at q
                        if _n_pairs(seq[start + 9 : start + 13], seq[q - 4 : q]) < 3:
                            continue
                        raw = (
                            t_pts
                            + acc_pts
                            + _pair_points(ac5, ac3)
                            + _pair_points(seq[start + 9 : start + 13], seq[q - 4 : q])
                        )
                        # conserved-base bonuses: the anchored T-loop
                        # T54-Psi55-C56 (+3), U33 before the anticodon
                        # (+2), purine 37 after it (+1)
                        raw += 3.0
                        if seq[q + 6 : q + 7] == "T":
                            raw += 2.0
                        if seq[q + 10 : q + 11] in ("A", "G"):
                            raw += 1.0
                        score = _SCALE * raw
                        if score >= min_score:
                            anticodon = seq[q + 7 : q + 10]
                            aa = _anticodon_to_aa(anticodon)
                            cand = (start, m + 19, score, aa)
                            if best is None or score > best[2]:
                                best = cand
        if best is not None:
            yield best
        m = seq.find("TTC", m + 1)


def find_trnas(seq: str, min_score: float = DEFAULT_THRESHOLD) -> list[tuple[int, int, str]]:
    """Detected tRNAs as (start, end, aa) with 1-based inclusive forward
    coordinates, overlaps resolved by score."""
    seq = seq.upper()
    n = len(seq)
    candidates = []
    for s0, e0, score, aa in _scan_strand(seq, min_score):
        candidates.append((s0 + 1, e0 + 1, score, aa))
    rc = seqlib.Sequence("x", seq).rc().seq
    for s0, e0, score, aa in _scan_strand(rc, min_score):
        candidates.append((n - e0, n - s0, score, aa))
    # overlap resolution: best score wins
    candidates.sort(key=lambda c: -c[2])
    chosen: list[tuple[int, int, str]] = []
    for s, e, score, aa in candidates:
        if all(e < cs or s > ce for cs, ce, _ in chosen):
            chosen.append((s, e, aa))
    chosen.sort()
    return chosen


class Aragorn:
    """Driver with the reference wrapper's contract (genomad/aragorn.py:11-97):
    scans every contig of ``input_file`` and appends
    ``<contig>_tRNA<i>_<aa>\\t<start>\\t<end>`` rows to ``aragorn_output``."""

    def __init__(self, input_file: Path, aragorn_output: Path, score_threshold: float = 1.05):
        self.input_file = Path(input_file)
        self.aragorn_output = Path(aragorn_output)
        # ARAGORN's -psN sets the acceptance cutoff to N% of its default
        # threshold (100 points); the reference's score_threshold 1.05
        # (`-ps105`, genomad/aragorn.py:13-17) therefore accepts at 105
        # points on the composite score scale — the actual -ps semantics,
        # not a rescaled pair count.
        self.score_threshold = score_threshold
        self.min_score = 100.0 * score_threshold

    def run_parallel_aragorn(self, threads: int | None = None) -> None:
        if self.aragorn_output.is_file():
            self.aragorn_output.unlink()
        with open(self.aragorn_output, "w") as fout:
            for seq in seqlib.read_fasta(self.input_file):
                for i, (start, end, aa) in enumerate(
                    find_trnas(seq.seq, self.min_score), 1
                ):
                    fout.write(f"{seq.accession}_tRNA{i}_{aa}\t{start}\t{end}\n")
