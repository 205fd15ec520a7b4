"""Branch-attention fusion and score-calibration heads.

Both are tiny fixed-weight models executed per sequence:

* branch_attention — fuses the marker-branch and NN-branch score triplets,
  weighting the marker branch by the sequence's total marker coverage.
  Weights are frozen training artifacts, identical to the numpy literals in
  the reference (genomad/modules/aggregated_classification.py:10-34).

* calibration MLP — maps (sample composition, scores) -> calibrated scores
  through a 6 -> 20 -> 20 -> 3 tanh network with per-classifier weight sets
  (reference: genomad/modules/score_calibration.py:15-43; weights bundled in
  score_calibration_weights.npz).

A copy of ``genomad_tpu/models/fusion.py`` (numpy).
"""

from __future__ import annotations

import numpy as np

from genomad_torch import utils

# Frozen BranchAttention weights (training-time analog: igloo.py:305-333).
_W1 = np.array([[0.3598502, 2.912244, -1.0668367, 1.3729712, -2.1972055, 0.9363847]])
_W2 = np.array([[1.5372132, 2.6216774, -2.8225133, 3.0680428, 2.803005, -1.1982375]])
_DENSE_W = np.array(
    [
        [1.6666023, -1.1003100, -2.1425622],
        [-2.2625937, 2.7540822, -1.5622343],
        [1.9745151, 1.0952991, -2.7467837],
    ]
)
_DENSE_B = np.array([0.14732242, -0.6838019, 0.5594167])


def branch_attention(marker_freq, marker_scores, nn_scores, temperature: float = 2):
    """Fuse the two classifier branches.

    marker_freq: (N,) total marker frequency per sequence (sum of features
    15:18, i.e. c/p/v marker freq); marker_scores, nn_scores: (N, 3).
    """
    marker_freq = np.asarray(marker_freq, dtype=np.float64).reshape(-1, 1)
    alpha = marker_freq @ _W1 + _W2
    weighted = (
        np.asarray(marker_scores) * alpha[:, 0:3] + np.asarray(nn_scores) * alpha[:, 3:6]
    ) / 2
    return utils.softmax(weighted @ _DENSE_W + _DENSE_B, temperature=temperature)


def get_empirical_sample_composition(score_array) -> np.ndarray:
    """Class composition from argmax frequencies
    (reference: score_calibration.py:9-12)."""
    score_array = np.asarray(score_array)
    counts = np.bincount(score_array.argmax(1), minlength=score_array.shape[1])
    return counts / counts.sum()


def score_batch_correction(scores, composition, classifier: str, weights_file) -> np.ndarray:
    """Calibrate scores against the sample composition
    (reference: score_calibration.py:15-43)."""
    composition = np.asarray(composition, dtype=np.float64)
    # Shrink the calibration effect for skewed compositions
    smoothing_coef = 1 - utils.specificity(composition) * 0.3
    composition = composition * smoothing_coef + (np.ones(3) / 3) * (1 - smoothing_coef)
    if classifier not in {"marker", "aggregated", "nn"}:
        classifier = "aggregated"
    scores = np.asarray(scores)
    x = np.concatenate(
        [np.repeat(composition[None, :], scores.shape[0], 0), scores], axis=1
    )
    with np.load(weights_file) as npz:
        for layer in (1, 2, 3):
            x = x @ npz[f"kernel_{layer}_{classifier}"] + npz[f"bias_{layer}_{classifier}"]
            if layer < 3:
                x = np.tanh(x)
    return utils.softmax(x)
