"""Plain NumPy reference of find-proviruses' decode (geNomad v1.12.0,
genomad/modules/find_proviruses.py:50-377 and cli.py:565-590): from the
genes of a contig, in order, with their marker class and SPM scores,
integrase flags and tRNAs, the provirus regions it reports.

- Target contigs carry at least one chromosome (class ``C*``) and one
  virus (``V*``) marker.
- A 2-state linear-chain CRF (labels V, host; attributes spm_v, spm_c,
  the weights of geNomad's ``provirus_tagger.crfsuite``) gives each gene
  P(V) by forward-backward, in float64; the score is
  logistic((P(V) - P(V | no attributes)) / 0.2), tagged at 0.4.
- Small islands are absorbed: host runs into the virus, then virus runs
  into the host (edge and inner thresholds on genes and own markers).
- Edges move to the reciprocal-nearest integrase (10 kbp) and then tRNA
  (5 kbp) unless a chromosome marker lies between.
- An island is kept by its summed exp(spm_v) - exp(spm_c): 8 at a contig
  edge or with an integrase, 12 otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# [attribute (spm_v, spm_c), label (V, host)] and [from, to] (crfsuite model)
STATE = np.array([[3.300215911627542, -3.3002159116212413], [-1.1674863958607502, 1.1674863958417414]])
TRANSITION = np.array([[1.4011465610478524, -1.420126254348839], [-1.4149055448977685, 1.4338852381987928]])
TEMPERATURE = 0.2
THRESHOLD = 0.4
# (genes, own markers) an island needs to stay, at a contig edge and inside
HOST_EDGE, HOST_ISLAND = (4, 1), (6, 2)
VIRUS_EDGE, VIRUS_ISLAND = (3, 1), (5, 1)
INTEGRASE_BP, TRNA_BP = 10_000, 5_000
KEEP_PLAIN, KEEP_INTEGRASE, KEEP_EDGE = 12.0, 8.0, 8.0


@dataclass
class Contig:
    name: str
    starts: np.ndarray  # int, 1-based, the genes in order
    ends: np.ndarray
    spm_c: np.ndarray
    spm_v: np.ndarray
    c_marker: np.ndarray  # bool
    v_marker: np.ndarray
    integrase: np.ndarray
    trnas: list  # [(start, end)], in the order found


def _logsumexp(a, axis):
    m = a.max(axis=axis, keepdims=True)
    return (m + np.log(np.exp(a - m).sum(axis=axis, keepdims=True))).squeeze(axis)


def marginal_v(state: np.ndarray) -> np.ndarray:
    """P(label V) at each of T positions from (T, 2) log-potentials."""
    T = len(state)
    alpha = np.empty((T, 2))
    beta = np.zeros((T, 2))
    alpha[0] = state[0]
    for t in range(1, T):
        alpha[t] = state[t] + _logsumexp(alpha[t - 1][:, None] + TRANSITION, 0)
    for t in range(T - 2, -1, -1):
        beta[t] = _logsumexp(TRANSITION + (state[t + 1] + beta[t + 1])[None, :], 1)
    joint = alpha + beta
    return np.exp(joint[:, 0] - _logsumexp(joint, 1))


def scores(c: Contig) -> np.ndarray:
    state = np.stack([c.spm_v, c.spm_c], 1) @ STATE
    delta = marginal_v(state) - marginal_v(np.zeros_like(state))
    return 1.0 / (1.0 + np.exp(-delta / TEMPERATURE))


def _runs(labels) -> list:
    """[(first, stop, value)] of the runs of equal labels."""
    out, first = [], 0
    for i in range(1, len(labels) + 1):
        if i == len(labels) or labels[i] != labels[first]:
            out.append((first, i, int(labels[first])))
            first = i
    return out


def _absorb(labels, c: Contig, value: int, edge, island) -> np.ndarray:
    """Flips each run of ``value`` that is too small, judged on the runs
    as they were before any flip."""
    out = labels.copy()
    runs = _runs(labels)
    for k, (a, b, v) in enumerate(runs):
        if v != value:
            continue
        n_c = int((c.spm_c[a:b] > c.spm_v[a:b]).sum())
        n_v = int((c.spm_v[a:b] > c.spm_c[a:b]).sum())
        own, other = (n_v, n_c) if value else (n_c, n_v)
        genes, markers = edge if k in (0, len(runs) - 1) else island
        if b - a < genes or own < markers or own <= other:
            out[a:b] = 1 - value
    return out


def _extend(labels, c: Contig, features: list, max_bp: int) -> np.ndarray:
    """Moves each provirus edge to the feature nearest to it, where that
    provirus is also the feature's nearest and no chromosome marker lies
    in between."""
    if not features or len(set(labels.tolist())) < 2:
        return labels
    regions = [[int(c.starts[a]), int(c.ends[b - 1])] for a, b, v in _runs(labels) if v == 1]
    dist = np.array([
        [fe - pe if fs > pe else (fs - ps if fe < ps else 0) for ps, pe in regions] for fs, fe in features
    ])
    markers = [(int(s), int(e)) for s, e, m in zip(c.starts, c.ends, c.c_marker) if m]
    nearest_region = np.abs(dist).argmin(1)
    nearest_feature = np.abs(dist).argmin(0)
    moved = False
    for f, r in enumerate(nearest_region):
        d = int(dist[f, r])
        if abs(d) > max_bp or nearest_feature[r] != f:
            continue
        lo, hi = regions[r]
        if d > 0 and not any(ms >= hi and me <= hi + d for ms, me in markers):
            regions[r][1] = hi + d
            moved = True
        elif d < 0 and not any(me <= lo and ms >= lo + d for ms, me in markers):
            regions[r][0] = lo + d
            moved = True
    if not moved:
        return labels
    return np.array([int(any(s >= lo and e <= hi for lo, hi in regions)) for s, e in zip(c.starts, c.ends)])


def proviruses(c: Contig, flip=()) -> list:
    """[(contig, start, end, n_genes, v_vs_c, in_edge, integrase genes
    (1-based))]; ``flip``: genes tagged against their score."""
    if not (c.c_marker.any() and c.v_marker.any()):
        return []
    labels = (scores(c) >= THRESHOLD).astype(int)
    labels[list(flip)] ^= 1
    labels = _absorb(labels, c, 0, HOST_EDGE, HOST_ISLAND)
    labels = _absorb(labels, c, 1, VIRUS_EDGE, VIRUS_ISLAND)
    ints = [(int(s), int(e)) for s, e, i in zip(c.starts, c.ends, c.integrase) if i]
    labels = _extend(labels, c, ints, INTEGRASE_BP)
    labels = _extend(labels, c, c.trnas, TRNA_BP)
    if len(set(labels.tolist())) < 2:
        return []
    v_vs_c = np.exp(c.spm_v) - np.exp(c.spm_c)
    runs = _runs(labels)
    out = []
    for k, (a, b, v) in enumerate(runs):
        if v != 1:
            continue
        total = float(v_vs_c[a:b].sum())
        has_int = bool(c.integrase[a:b].any())
        edge = k in (0, len(runs) - 1)
        if (edge and total >= KEEP_EDGE) or (has_int and total >= KEEP_INTEGRASE) or (not edge and not has_int and total >= KEEP_PLAIN):
            genes = tuple(int(g) + 1 for g in np.flatnonzero(c.integrase[a:b]) + a)
            out.append((c.name, int(c.starts[a]), int(c.ends[b - 1]), b - a, total, edge, genes))
    return out


def readings(c: Contig, margin: float = 1e-3, most: int = 4) -> list | None:
    """Every table the contig can give: the genes whose score lies within
    ``margin`` of the tag threshold, where the program's float32
    forward-backward (off by up to about 1e-4 over hundreds of genes) could
    tag them otherwise, are taken both ways. None where more than ``most``
    genes lie there."""
    unsure = np.flatnonzero(np.abs(scores(c) - THRESHOLD) < margin)
    if len(unsure) > most:
        return None
    out = []
    for k in range(1 << len(unsure)):
        table = proviruses(c, [g for b, g in enumerate(unsure) if k >> b & 1])
        if table not in out:
            out.append(table)
    return out
