"""BLOSUM62 substitution matrix + similar-k-mer enumeration.

The prefilter's sensitivity knob follows MMseqs2's actual semantics
(reference: genomad/mmseqs2.py:76-96 runs ``mmseqs prefilter -s 4.2`` /
``-s 8.2``): each QUERY k-mer is expanded into the list of k-mers whose
BLOSUM62 similarity to it reaches a score threshold, and every k-mer in the
list is looked up in the target index. Higher sensitivity lowers the
threshold, growing the lists (and recall) at prefilter cost. This replaces
the round-1 DB-side top-N residue expansion, which had a different recall
curve (VERDICT round 1, missing #3).

The enumeration is a branch-and-bound DFS over the k positions with
suffix-max pruning; the C++ prefilter implements the identical algorithm
(native/prefilter.cpp) and is parity-tested against this one.

A k-mer whose self-score is below the threshold yields no matches at all —
the same low-complexity masking effect the absolute threshold has in
MMseqs2.

A copy of ``genomad_tpu/ops/blosum.py``.
"""

from __future__ import annotations

import numpy as np

from genomad_torch.ops.profiledb import ALPHABET, KMER_K, N_AA

# The standard BLOSUM62 matrix in its canonical row order; remapped below to
# this package's alphabet (profiledb.ALPHABET = "ACDEFGHIKLMNPQRSTVWY").
_CANON_ORDER = "ARNDCQEGHILKMFPSTWYV"
_CANON = np.array(
    [
        [4, -1, -2, -2, 0, -1, -1, 0, -2, -1, -1, -1, -1, -2, -1, 1, 0, -3, -2, 0],
        [-1, 5, 0, -2, -3, 1, 0, -2, 0, -3, -2, 2, -1, -3, -2, -1, -1, -3, -2, -3],
        [-2, 0, 6, 1, -3, 0, 0, 0, 1, -3, -3, 0, -2, -3, -2, 1, 0, -4, -2, -3],
        [-2, -2, 1, 6, -3, 0, 2, -1, -1, -3, -4, -1, -3, -3, -1, 0, -1, -4, -3, -3],
        [0, -3, -3, -3, 9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1],
        [-1, 1, 0, 0, -3, 5, 2, -2, 0, -3, -2, 1, 0, -3, -1, 0, -1, -2, -1, -2],
        [-1, 0, 0, 2, -4, 2, 5, -2, 0, -3, -3, 1, -2, -3, -1, 0, -1, -3, -2, -2],
        [0, -2, 0, -1, -3, -2, -2, 6, -2, -4, -4, -2, -3, -3, -2, 0, -2, -2, -3, -3],
        [-2, 0, 1, -1, -3, 0, 0, -2, 8, -3, -3, -1, -2, -1, -2, -1, -2, -2, 2, -3],
        [-1, -3, -3, -3, -1, -3, -3, -4, -3, 4, 2, -3, 1, 0, -3, -2, -1, -3, -1, 3],
        [-1, -2, -3, -4, -1, -2, -3, -4, -3, 2, 4, -2, 2, 0, -3, -2, -1, -2, -1, 1],
        [-1, 2, 0, -1, -3, 1, 1, -2, -1, -3, -2, 5, -1, -3, -1, 0, -1, -3, -2, -2],
        [-1, -1, -2, -3, -1, 0, -2, -3, -2, 1, 2, -1, 5, 0, -2, -1, -1, -1, -1, 1],
        [-2, -3, -3, -3, -2, -3, -3, -3, -1, 0, 0, -3, 0, 6, -4, -2, -2, 1, 3, -1],
        [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4, 7, -1, -1, -4, -3, -2],
        [1, -1, 1, 0, -1, 0, 0, 0, -1, -2, -2, 0, -1, -2, -1, 4, 1, -3, -2, -2],
        [0, -1, 0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1, 1, 5, -2, -2, 0],
        [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1, 1, -4, -3, -2, 11, 2, -3],
        [-2, -2, -2, -3, -2, -1, -2, -3, 2, -1, -1, -2, -1, 3, -3, -2, -2, 2, 7, -1],
        [0, -3, -3, -3, -1, -2, -2, -3, -3, 3, 1, -2, 1, -1, -2, -2, 0, -3, -1, 4],
    ],
    dtype=np.float32,
)

_PERM = np.array([_CANON_ORDER.index(aa) for aa in ALPHABET])
BLOSUM62 = np.ascontiguousarray(_CANON[np.ix_(_PERM, _PERM)])


# --- local composition-bias correction (MMseqs2 --comp-bias-corr 1) --------
#
# geNomad's search chain inherits MMseqs2's default composition-bias
# correction silently (it passes no --comp-bias-corr flag —
# genomad/mmseqs2.py:76-96). MMseqs2's SubstitutionMatrix::
# calcLocalAaBiasCorrection computes, per query position i over a
# 40-residue window [i-20, i+20):
#
#   deltaS_i = -(sum_{j in window} s(q_i, q_j) - s(q_i, q_i)) / (wl - 1)
#              + sum_a pBack_a * s(q_i, a)
#
# i.e. the expected background score of residue q_i minus its mean score
# against its own neighborhood — strongly negative inside low-complexity /
# compositionally biased runs. The correction is added per query position
# to (a) the per-position score rows the similar-k-mer generator expands
# (equivalently: the k-mer threshold rises by the window's bias sum) and
# (b) the ungapped diagonal scores of the prefilter. The align stage is
# NOT corrected here: in the reference's swapped orientation the align
# query is a PROFILE, and the sequence-side bias correction is a
# query-side mechanism (see PARITY.md round-5 notes).
#
# Engine-specific choices (documented, shared bit-exactly by the numpy and
# C++ paths): corrections are rounded half-up to integers (the int8
# diagonal scan accumulates in int32 and must stay exact); invalid (X)
# positions get bias 0 and contribute 0 inside windows while still
# counting toward the window length; the per-k-mer threshold reduction is
# clamped at COMP_BIAS_SLACK so the precomputed expansion tables (built
# once at threshold - SLACK) stay exhaustive.

COMP_BIAS_WINDOW = 40
COMP_BIAS_SLACK = 16.0


def comp_bias(residues: np.ndarray) -> np.ndarray:
    """Rounded integer composition-bias corrections, one per position."""
    from genomad_torch.ops.statistics import BACKGROUND_FREQS

    res = np.asarray(residues, np.int64)
    L = len(res)
    if L < 2:
        return np.zeros(L, np.int32)
    valid = res < N_AA
    half = COMP_BIAS_WINDOW // 2
    pos = np.arange(L)
    lo = np.maximum(0, pos - half)
    hi = np.minimum(L, pos + half)
    wl = hi - lo
    # windowed residue-type counts via cumulative sums: (N_AA, L+1)
    onehot = np.zeros((N_AA, L + 1), np.int64)
    onehot[res[valid], pos[valid] + 1] = 1
    csum = np.cumsum(onehot, axis=1)
    win_counts = csum[:, hi] - csum[:, lo]  # (N_AA, L)
    rows = BLOSUM62[np.where(valid, res, 0)]  # (L, N_AA); row irrelevant at ~valid
    win_sum = np.einsum("la,al->l", rows, win_counts.astype(np.float64))
    self_score = rows[np.arange(L), np.where(valid, res, 0)]
    bg = rows @ BACKGROUND_FREQS
    denom = np.maximum(wl - 1, 1)
    bias = -(win_sum - self_score) / denom + bg
    bias = np.where(valid & (wl > 1), bias, 0.0)
    return np.floor(bias + 0.5).astype(np.int32)


def kmer_score_threshold(sensitivity: float) -> float:
    """Similar-k-mer score threshold (BLOSUM62 units, k=5) for an MMseqs2
    ``-s`` value. Linear, like MMseqs2's kmerThr(s): higher sensitivity
    lowers the bar. Measured list lengths over background-distributed
    k-mers (tools/calibrate_sensitivity.py): median 1 at s=1, ~10^2 at the
    default s=4.2, ~10^4 at the integrase search's s=8.2 (reference
    cli.py:592-599 passes 8.2 there)."""
    return 27.0 - 2.0 * float(sensitivity)


def similar_kmers(kmer: np.ndarray, threshold: float) -> tuple[np.ndarray, np.ndarray]:
    """All k-mers x (as base-20 codes) with sum_i B62[kmer_i, x_i] >= threshold.

    Returns (codes, scores), enumeration order = lexicographic in residue
    rank (descending substitution score per position). Branch-and-bound with
    suffix-max pruning; the exact k-mer is included iff its self-score
    reaches the threshold.
    """
    k = len(kmer)
    # per position: substitution residues sorted by score descending
    rows = BLOSUM62[np.asarray(kmer, np.int64)]  # (k, 20)
    order = np.argsort(-rows, axis=1, kind="stable")
    sorted_scores = np.take_along_axis(rows, order, axis=1)
    suffix_max = np.concatenate([np.cumsum(sorted_scores[::-1, 0])[::-1], [0.0]])
    weights = N_AA ** np.arange(k - 1, -1, -1, dtype=np.int64)
    out_codes: list[int] = []
    out_scores: list[float] = []

    def dfs(pos: int, code: int, score: float) -> None:
        if pos == k:
            out_codes.append(code)
            out_scores.append(score)
            return
        for r in range(N_AA):
            s = float(sorted_scores[pos, r])
            # residues are score-sorted: once one fails the bound, all rest do
            if score + s + suffix_max[pos + 1] < threshold:
                break
            dfs(pos + 1, code + int(order[pos, r]) * int(weights[pos]), score + s)

    dfs(0, 0, 0.0)
    return np.asarray(out_codes, np.int64), np.asarray(out_scores, np.float32)
