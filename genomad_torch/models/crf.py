"""Provirus gene tagger: 2-state linear-chain CRF marginals.

Port of ``genomad_tpu/models/crf.py`` (weights and scoring protocol are
copied). It replaces the reference's CRFsuite C engine
(genomad/modules/find_proviruses.py:50-69, model file
provirus_tagger.crfsuite). The 8 model weights were extracted from the
binary (format lCRF/FOMC, 2 labels {V, host}, 2 continuous attributes
{spm_v, spm_c}; attribute value multiplies the feature weight):

  state:      spm_v->V +3.300215911627542   spm_v->host -3.3002159116212413
              spm_c->V -1.1674863958607502  spm_c->host +1.1674863958417414
  transition: V->V +1.4011465610478524      V->host -1.420126254348839
              host->V -1.4149055448977685   host->host +1.4338852381987928

Scoring protocol (find_proviruses.py:56-69): per-gene marginal P(V) under
the real attributes minus the marginal under empty attributes (transitions
only), then logistic(delta, temperature=0.2).

The forward-backward pass is a Python loop over gene positions in f32 (the
JAX package's ``jax.lax.scan``; it never enables x64), vectorized over a
padded batch of contigs on ``device``: about ten small operations per step
over the longest contig's gene count. Plain PyTorch: JAX runs it as XLA.
Counters (``genomad_torch.trace``): ``crf.contigs`` scored and ``crf.steps``,
the positions stepped by the forward and the backward loop of a batch
(2 x (T - 1) for T genes; each position is stepped for the scored and the
background pass).
"""

from __future__ import annotations

import numpy as np
import torch

from genomad_torch import trace
from genomad_torch.device import resolve_device

# [attribute (spm_v, spm_c), label (V, host)]
STATE_WEIGHTS = np.array(
    [
        [3.300215911627542, -3.3002159116212413],
        [-1.1674863958607502, 1.1674863958417414],
    ]
)
# [from label, to label]
TRANSITION_WEIGHTS = np.array(
    [
        [1.4011465610478524, -1.420126254348839],
        [-1.4149055448977685, 1.4338852381987928],
    ]
)


def _forward_backward_marginals(state_scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Marginal P(label=V) per position for a batch of padded sequences.

    state_scores: (B, T, 2) log-potentials; mask: (B, T) 1 for real positions.
    Padded positions have their state scores zeroed and transitions into them
    disabled, making the marginal independent of padding length.
    """
    trans = torch.as_tensor(TRANSITION_WEIGHTS, dtype=state_scores.dtype, device=state_scores.device)
    state_scores = state_scores * mask[..., None]
    T = state_scores.shape[1]
    real = mask != 0

    alpha = state_scores[:, 0]
    alphas = [alpha]
    for t in range(1, T):
        new = state_scores[:, t] + torch.logsumexp(alpha[:, :, None] + trans[None], dim=1)
        alpha = torch.where(real[:, t, None], new, alpha)
        alphas.append(alpha)

    beta = torch.zeros_like(alpha)
    betas = [beta]
    for t in range(T - 1, 0, -1):
        new = torch.logsumexp(trans[None] + (state_scores[:, t] + beta)[:, None, :], dim=2)
        beta = torch.where(real[:, t, None], new, beta)
        betas.append(beta)

    log_joint = torch.stack(alphas, dim=1) + torch.stack(betas[::-1], dim=1)  # (B, T, 2)
    log_z = torch.logsumexp(log_joint, dim=2, keepdim=True)
    return torch.exp(log_joint - log_z)[..., 0]  # P(V), (B, T)


def _score_batch(spm_v: torch.Tensor, spm_c: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    state_w = torch.as_tensor(STATE_WEIGHTS, dtype=torch.float32, device=spm_v.device)
    attrs = torch.stack([spm_v, spm_c], dim=-1)  # (B, T, 2)
    scores = attrs @ state_w  # (B, T, 2)
    marginals = _forward_backward_marginals(scores, mask)
    background = _forward_backward_marginals(torch.zeros_like(scores), mask)
    delta = marginals - background
    return 1.0 / (1.0 + torch.exp(-delta / 0.2))


def score_provirus_genes(spm_v_array, spm_c_array, device=None) -> np.ndarray:
    """Per-gene provirus scores for one contig (reference protocol,
    find_proviruses.py:56-69)."""
    device = resolve_device(device)
    n = len(spm_v_array)
    if n == 0:
        return np.zeros(0)
    return score_provirus_genes_batch([spm_v_array], [spm_c_array], device=device)[0]


def score_provirus_genes_batch(spm_v_list, spm_c_list, device=None) -> list[np.ndarray]:
    """Score many contigs at once: pad to the max gene count and run one
    batched forward-backward on ``device`` (None = the card; raises
    without one)."""
    device = resolve_device(device)
    if not spm_v_list:
        return []
    lengths = [len(v) for v in spm_v_list]
    T = max(max(lengths), 1)
    B = len(spm_v_list)
    trace.count_many({"crf.contigs": B, "crf.steps": 2 * (T - 1)})
    spm_v = np.zeros((B, T), np.float32)
    spm_c = np.zeros((B, T), np.float32)
    mask = np.zeros((B, T), np.float32)
    for i, (v, c) in enumerate(zip(spm_v_list, spm_c_list)):
        spm_v[i, : lengths[i]] = v
        spm_c[i, : lengths[i]] = c
        mask[i, : lengths[i]] = 1

    def to_device(a):
        return torch.from_numpy(a).to(device)

    with torch.inference_mode():
        scores = _score_batch(to_device(spm_v), to_device(spm_c), to_device(mask)).cpu().numpy()
    return [scores[i, : lengths[i]] for i in range(B)]
