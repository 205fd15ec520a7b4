"""Batched affine-gap local Smith-Waterman of residue rows against PSSMs:
kernel K1 (``sw_pairs``), its plain PyTorch version and ``sw_align``.

Counterpart of ``genomad_tpu/ops/protein_search.py`` ``_sw_forward`` (the
oracle, a ``lax.scan`` over query rows) and of its three Pallas tilings in
``genomad_tpu/ops/sw_pallas.py``. The kernel is written by hand for Hopper
in ``genomad_torch/csrc/sw.cu`` (see the note at its top). The wrapper
launches it for CUDA tensors (or raises) and takes the plain version only
for tensors on the CPU. ``sw_pairs.launches`` counts kernel launches;
``sw_pairs.forward_launches`` and ``sw_pairs.reverse_launches`` split them
by pass, and ``sw_pairs.long_launches`` counts those of the long body
(profile buckets above 1,024 columns).

The function (gap open 11, extend 1; a gap of length g costs 11 + (g-1)):
for each pair, the best local-alignment score of the query row against the
profile and its first end cell (query row, profile column), 0-indexed. A
later row replaces the best only when it is strictly greater; within a row
the first column of the maximum wins. A pair with no positive cell gives
(0, 0, 0). Query code 20 is pad/unknown and scores the profile's column 20
(zero in every staged bucket).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from genomad_torch.device import resolve_device
from genomad_torch.ops import _build

GAP_OPEN = 11.0
GAP_EXTEND = 1.0
N_COLS = 21  # 20 residues + the pad/unknown column
PAD_CODE = 20

# longer profile buckets take the kernel's long body (CHUNK_MAX_LP in
# csrc/sw.cu): column slabs with two floats of carries per row between
# them, in a buffer of the grid's size that the wrapper allocates
_CHUNK_MAX_LP = 1024

_SIGNATURES = {
    "sw_carry_warps": [_build.I] * 3 + [_build.P],
    "sw_pairs_launch": [_build.P] * 10 + [_build.I] * 5 + [_build.P],
}


def sw_forward_plain(q: torch.Tensor, p: torch.Tensor):
    """``_sw_forward`` on gathered operands, in its operation order.

    q: (B, Lq) integer residue codes (20 = pad); p: (B, Lp, 21) float32.
    Returns best (B,) float32, end_i (B,) int32, end_j (B,) int32.
    """
    B, Lq = q.shape
    Lp = p.shape[1]
    dev = p.device
    col = torch.arange(Lp, dtype=torch.float32, device=dev)
    p_t = p.float().transpose(1, 2)  # (B, 21, Lp)
    h = torch.zeros((B, Lp), dtype=torch.float32, device=dev)
    f = torch.full((B, Lp), float("-inf"), dtype=torch.float32, device=dev)
    best = torch.zeros(B, dtype=torch.float32, device=dev)
    best_i = torch.zeros(B, dtype=torch.int32, device=dev)
    best_j = torch.zeros(B, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    q = q.long()
    for i in range(Lq):
        s_row = torch.gather(p_t, 1, q[:, i, None, None].expand(B, 1, Lp))[:, 0, :]
        f = torch.maximum(h - GAP_OPEN, f - GAP_EXTEND)
        diag = F.pad(h[:, :-1], (1, 0))
        h0 = torch.maximum(torch.maximum(diag + s_row, f), zero)
        # horizontal gaps: E_j = max_{k<j}(h0_k - open + k*ext) - (j-1)*ext
        t = h0 - GAP_OPEN + col
        m = torch.cummax(t, dim=1).values
        m = F.pad(m[:, :-1], (1, 0), value=float("-inf"))
        e = m - (col - 1.0)
        h = torch.maximum(h0, e)
        row_best = h.amax(dim=1)
        row_arg = h.argmax(dim=1)  # first index of the maximum
        improved = row_best > best
        best = torch.where(improved, row_best, best)
        best_i = torch.where(improved, torch.full_like(best_i, i), best_i)
        best_j = torch.where(improved, row_arg.int(), best_j)
    return best, best_i, best_j


def _gather_operands(all_q, all_p, idx, ends):
    """The (N, Lq) queries and (N, Lp, 21) f32 profiles of each pair; for
    the reverse pass the prefixes ending at ``ends`` reversed, padded with
    code 20 and zero rows (``protein_search._sw_rev_cov``)."""
    q = all_q[idx[0].long()]
    p = all_p[idx[1].long()].float()
    if ends is None:
        return q, p
    Lq, Lp = q.shape[1], p.shape[1]
    dev = q.device
    tq = ends[0].long()[:, None] - torch.arange(Lq, device=dev)[None, :]
    q = torch.where(tq >= 0, torch.gather(q, 1, tq.clamp_min(0)), torch.full_like(q, PAD_CODE))
    tp = ends[1].long()[:, None] - torch.arange(Lp, device=dev)[None, :]
    rows = torch.gather(p, 1, tp.clamp_min(0)[:, :, None].expand(-1, -1, p.shape[2]))
    p = torch.where((tp >= 0)[:, :, None], rows, torch.zeros_like(rows))
    return q, p


def sw_pairs_plain(all_q, all_p, idx, ends=None, lengths=None):
    """Plain version of :func:`sw_pairs`: gathers the operands and runs
    :func:`sw_forward_plain` over the full bucket. ``lengths`` is accepted
    and not needed: padding cells score 0 and never beat a real cell."""
    del lengths
    return sw_forward_plain(*_gather_operands(all_q, all_p, idx, ends))


def sw_pairs(all_q, all_p, idx, ends=None, lengths=None):
    """Smith-Waterman of pairs drawn from a staged query and profile bucket.

    all_q: (nq, Lq) int32 residue codes (20 = pad); all_p: (np, Lp, 21)
    float32 or bfloat16 PSSMs (bf16 is exact for integral scores and is
    converted to f32 in the kernel); idx: (2, N) int32 rows into all_q and
    all_p. ``ends``: (2, N) int32 (end_i, end_j) of a forward pass selects
    the reverse pass: the pair's prefixes ending there, reversed, whose end
    cell gives the alignment's start. ``lengths``: optional ((nq,), (np,))
    int32 real lengths; the kernel then stops at them, which gives the same
    result when the padding scores 0 (query code 20 on a zero column 20,
    zero profile rows past the length), as in every staged bucket.

    Returns best (N,) float32, end_i (N,) int32, end_j (N,) int32. Indices
    are trusted to lie in range.
    """
    tensors = [all_q, all_p, idx] + ([ends] if ends is not None else []) + (list(lengths) if lengths is not None else [])
    if not _build.on_cuda(*tensors):
        return sw_pairs_plain(all_q, all_p, idx, ends, lengths)
    _build.refuse_grad("sw_pairs", all_p)
    _build.require(all_q.dim() == 2 and all_q.dtype == torch.int32, "all_q must be (nq, Lq) int32")
    _build.require(all_p.dim() == 3 and all_p.shape[2] == N_COLS, "all_p must be (np, Lp, 21)")
    _build.require(all_p.dtype in _build.DTYPES, "all_p must be float32 or bfloat16")
    _build.require(idx.dim() == 2 and idx.shape[0] == 2 and idx.dtype == torch.int32, "idx must be (2, N) int32")
    N = idx.shape[1]
    if ends is not None:
        _build.require(ends.shape == (2, N) and ends.dtype == torch.int32, "ends must be (2, N) int32")
    if lengths is not None:
        q_len, p_len = lengths
        _build.require(
            q_len.shape == (all_q.shape[0],) and p_len.shape == (all_p.shape[0],)
            and q_len.dtype == torch.int32 and p_len.dtype == torch.int32,
            "lengths must be ((nq,), (np,)) int32",
        )
    _build.require(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    dev = all_q.device
    best = torch.empty(N, dtype=torch.float32, device=dev)
    end_i = torch.empty(N, dtype=torch.int32, device=dev)
    end_j = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return best, end_i, end_j
    Lq, Lp = all_q.shape[1], all_p.shape[1]
    is_bf16 = int(all_p.dtype == torch.bfloat16)
    lib = _build.load("sw", _SIGNATURES)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        carry, warps = None, ctypes.c_int(0)
        if Lp > _CHUNK_MAX_LP:  # the long body's grid, its pair counter and each of its warps' row carries
            _build.check(lib.sw_carry_warps(N, Lp, is_bf16, ctypes.byref(warps)), "sw_pairs")
            carry = torch.empty((1 + warps.value * Lq, 2), dtype=torch.float32, device=dev)
        err = lib.sw_pairs_launch(
            all_q.data_ptr(), all_p.data_ptr(), idx.data_ptr(), ptr(ends),
            ptr(lengths[0] if lengths is not None else None), ptr(lengths[1] if lengths is not None else None),
            best.data_ptr(), end_i.data_ptr(), end_j.data_ptr(), ptr(carry), warps.value,
            N, Lq, Lp, is_bf16, _build.stream_ptr(dev),
        )
    _build.check(err, "sw_pairs")
    sw_pairs.launches += 1
    if Lp > _CHUNK_MAX_LP:
        sw_pairs.long_launches += 1
    if ends is None:
        sw_pairs.forward_launches += 1
    else:
        sw_pairs.reverse_launches += 1
    return best, end_i, end_j


sw_pairs.launches = 0
sw_pairs.forward_launches = 0
sw_pairs.reverse_launches = 0
sw_pairs.long_launches = 0


def sw_align(queries: np.ndarray, profiles: np.ndarray, compute_starts: bool = False, device=None):
    """Forward (and optionally reverse) SW over a padded batch, on
    ``device`` (None = cuda; raises without a card).

    queries: (B, Lq) int residue indices padded with 20.
    profiles: (B, Lp, 20) float PSSMs padded with zero rows.

    Returns dict with score, end_i, end_j (+ start_i, start_j and
    score_rev when compute_starts): inclusive 0-indexed alignment
    boundaries, as ``protein_search.sw_align`` of the JAX package.
    """
    device = resolve_device(device)
    queries = np.asarray(queries, np.int32)
    profiles = np.asarray(profiles, np.float32)
    prof21 = np.concatenate([profiles, np.zeros((*profiles.shape[:2], 1), np.float32)], axis=2)
    n = queries.shape[0]
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(device)
    p = torch.from_numpy(prof21).to(device)
    idx = torch.arange(n, dtype=torch.int32, device=device).repeat(2, 1)
    best, end_i, end_j = sw_pairs(q, p, idx)
    out = {"score": best.cpu().numpy(), "end_i": end_i.cpu().numpy(), "end_j": end_j.cpu().numpy()}
    if compute_starts:
        rbest, rev_i, rev_j = sw_pairs(q, p, idx, ends=torch.stack([end_i, end_j]))
        out["start_i"] = out["end_i"] - rev_i.cpu().numpy()
        out["start_j"] = out["end_j"] - rev_j.cpu().numpy()
        out["score_rev"] = rbest.cpu().numpy()  # == score (sanity invariant)
    return out
