"""Plain PyTorch reference of the marker search's alignment statistics:
affine-gap local Smith-Waterman of a protein against a profile (gap open
11, extend 1; a gap of g costs 11 + (g - 1)), the profile-side E-value
gate, the coverage of the profile and the reported bitscore and E-value
(MMseqs2's conventions, which geNomad reads: genomad/mmseqs2.py:97-174).

The recurrence per query row i, over profile columns j:
  F[i, j] = max(H[i-1, j] - open, F[i-1, j] - extend)
  H0[i, j] = max(H[i-1, j-1] + S[i, j], F[i, j], 0)
  E[i, j] = max over k < j of H0[i, k] - open - (j - 1 - k) * extend
  H[i, j] = max(H0[i, j], E[i, j])
The best score and its end cell: a later row replaces the best only when
strictly greater; within a row the first column of the maximum. The start
column comes from the same recurrence over the two prefixes ending there,
both reversed. Residue code 20 (unknown) scores 0. The recurrence runs in
float64 on the device given (the card after the benchmark's window, the
CPU in its tests), a block of pairs at a time.
"""

from __future__ import annotations

import numpy as np
import torch

GAP_OPEN = 11.0
GAP_EXTEND = 1.0
KA_LAMBDA = 0.267
KA_K = 0.041
LN2 = float(np.log(2.0))
ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
_AA = np.full(256, 20, np.int64)
for _i, _a in enumerate(ALPHABET):
    _AA[ord(_a)] = _i
    _AA[ord(_a.lower())] = _i


def encode(protein: str) -> np.ndarray:
    return _AA[np.frombuffer(protein.encode("ascii"), np.uint8)]


def _forward(q: torch.Tensor, p: torch.Tensor):
    """q (B, Lq) codes padded with 20; p (B, Lp, 21) float64 with column 20
    and padding rows zero -> best (B,), end_i (B,), end_j (B,)."""
    B, Lq = q.shape
    Lp = p.shape[1]
    col = torch.arange(Lp, dtype=torch.float64, device=p.device)
    h = torch.zeros((B, Lp), dtype=torch.float64, device=p.device)
    f = torch.full_like(h, -torch.inf)
    zero = torch.zeros((B, 1), dtype=torch.float64, device=p.device)
    ninf = torch.full_like(zero, -torch.inf)
    best = torch.zeros(B, dtype=torch.float64, device=p.device)
    best_i = torch.zeros(B, dtype=torch.int64, device=p.device)
    best_j = torch.zeros(B, dtype=torch.int64, device=p.device)
    for i in range(Lq):
        s = torch.gather(p, 2, q[:, i, None, None].expand(B, Lp, 1))[..., 0]
        f = torch.maximum(h - GAP_OPEN, f - GAP_EXTEND)
        diag = torch.cat([zero, h[:, :-1]], dim=1)
        h0 = torch.clamp_min(torch.maximum(diag + s, f), 0.0)
        m = torch.cummax(h0 - GAP_OPEN + col, dim=1).values
        e = torch.cat([ninf, m[:, :-1]], dim=1) - (col - 1.0)
        h = torch.maximum(h0, e)
        row_best, row_j = h.max(dim=1)
        improved = row_best > best
        best = torch.where(improved, row_best, best)
        best_i = torch.where(improved, i, best_i)
        best_j = torch.where(improved, row_j, best_j)
    return best.cpu().numpy(), best_i.cpu().numpy(), best_j.cpu().numpy()


def _pad(queries: list, profiles: list, device):
    n = len(queries)
    q = torch.full((n, max(len(x) for x in queries)), 20, dtype=torch.int64)
    p = torch.zeros((n, max(len(x) for x in profiles), 21), dtype=torch.float64)
    for k, (qq, pp) in enumerate(zip(queries, profiles)):
        q[k, : len(qq)] = torch.as_tensor(np.ascontiguousarray(qq, np.int64))
        p[k, : len(pp), :20] = torch.as_tensor(np.ascontiguousarray(pp, np.float64))
    return q.to(device), p.to(device)


def align(queries: list, profiles: list, device="cpu", block: int = 4096):
    """Pairs of (codes (Lq,), pssm (Lp, 20)) -> score, end_i, end_j and
    start_j per pair (0-indexed, inclusive)."""
    out = []
    for lo in range(0, len(queries), block):
        qs, ps = queries[lo : lo + block], profiles[lo : lo + block]
        best, end_i, end_j = _forward(*_pad(qs, ps, device))
        # the reverse pass: both prefixes ending at the end cell, reversed
        rev = [(qs[k][: end_i[k] + 1][::-1], np.asarray(ps[k])[: end_j[k] + 1][::-1]) for k in range(len(qs))]
        _, _, rev_j = _forward(*_pad([r[0] for r in rev], [r[1] for r in rev], device))
        out.append((best, end_i, end_j, end_j - rev_j))
    return tuple(np.concatenate(parts) for parts in zip(*out))


def gate_evalue(score, profile_len, search_space, lam=KA_LAMBDA, k=KA_K):
    """Align-stage E-value, profile as query: K * Lp * n * exp(-lambda S)."""
    return k * np.asarray(profile_len, np.float64) * search_space * np.exp(-lam * np.asarray(score, np.float64))


def int_bitscore(score, lam=KA_LAMBDA, k=KA_K):
    """MMseqs2's stored bitscore: (int)(bits + 0.5)."""
    return np.trunc((lam * np.asarray(score, np.float64) - np.log(k)) / LN2 + 0.5).astype(np.int64)


def reported_evalue(bits, query_len, db_positions):
    """The swapped-back E-value, gene length x DB positions x 2^-bits."""
    return np.asarray(query_len, np.float64) * db_positions * np.power(2.0, -np.asarray(bits, np.float64))
