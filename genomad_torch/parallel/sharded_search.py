"""All-pairs best hits with the profile axis sharded over a mesh.

Port of ``genomad_tpu/parallel/sharded_search.py``. The production search
prefilters on the host and aligns candidate pairs (ops.protein_search.search);
for small databases and dense scoring, this module scores every query
against every profile through K1 (``ops.sw.sw_pairs``): with a mesh, cell
(g, d) scores the g-th block of queries against the d-th block of profiles
on its device, the native replacement for MMseqs2 ``--splits`` serial
chunking (genomad/mmseqs2.py:83-95).

Ties break toward the smaller global profile index, whatever the shard count.
"""

from __future__ import annotations

import numpy as np
import torch

from genomad_torch.device import resolve_device
from genomad_torch.ops.sw import sw_pairs


def _score_block(queries: np.ndarray, prof21: np.ndarray, device) -> np.ndarray:
    """(Q, P) SW scores of every query against every profile on ``device``."""
    nq, npr = len(queries), len(prof21)
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(device)
    p = torch.from_numpy(np.ascontiguousarray(prof21)).to(device)
    idx = torch.stack([
        torch.arange(nq, dtype=torch.int32, device=device).repeat_interleave(npr),
        torch.arange(npr, dtype=torch.int32, device=device).repeat(nq),
    ])
    best, _, _ = sw_pairs(q, p, idx)
    return best.reshape(nq, npr).cpu().numpy()


def dense_best_hits(queries: np.ndarray, profiles: np.ndarray, mesh=None, device=None):
    """Best profile per query over a dense profile tensor.

    queries: (Q, Lq) int32 padded with 20; profiles: (P, Lp, 20) f32 padded
    with zero rows. Without a mesh every pair is scored on ``device`` (None
    = the card); with one, queries split over 'data' and profiles over
    'db', and each rank's cells score their blocks (``Mesh.gather`` joins
    the ranks'). Returns (best_profile (Q,), best_score (Q,)).
    """
    prof21 = np.concatenate([profiles, np.zeros((*profiles.shape[:2], 1), np.float32)], axis=2).astype(np.float32)
    queries = np.asarray(queries, np.int32)
    scores = np.zeros((len(queries), len(prof21)), np.float32)
    if mesh is None:
        scores[:] = _score_block(queries, prof21, resolve_device(device))
    else:
        q_blocks = np.array_split(np.arange(len(queries)), mesh.shape["data"])
        p_blocks = np.array_split(np.arange(len(prof21)), mesh.shape["db"])
        for g, d in mesh.rank_cells:
            qi, pi = q_blocks[g], p_blocks[d]
            if len(qi) and len(pi):
                scores[np.ix_(qi, pi)] = _score_block(queries[qi], prof21[pi], mesh.devices[g, d])
        scores = mesh.gather(scores)
    # np.argmax takes the first maximal element: ties -> the smaller profile index
    return scores.argmax(axis=1), scores.max(axis=1)
