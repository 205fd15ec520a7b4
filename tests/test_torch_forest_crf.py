"""The port's decision forest (``genomad_torch.models.forest``) and provirus
CRF (``genomad_torch.models.crf``) on the CPU against the JAX package's:
margins on ``synthetic_forest`` with NaN features, the UBJSON model file
both ways, and the CRF scores on ragged batches and single genes.

Both are plain PyTorch (JAX runs them as XLA, with no Pallas kernel); the
tolerances are the JAX package's own for these models
(``tests/test_crf_forest.py``): rtol 1e-5 / atol 1e-6, f32 sums in
another order."""

import numpy as np
import pytest
import torch

from genomad_torch.models import crf as tcrf
from genomad_torch.models import forest as tforest
from genomad_tpu.models import crf as jcrf
from genomad_tpu.models import forest as jforest

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _features(rng, n, n_features, nan_fraction=0.2):
    X = rng.uniform(0, 1, (n, n_features)).astype(np.float32)
    X[rng.uniform(0, 1, X.shape) < nan_fraction] = np.nan
    return X


@pytest.mark.parametrize("seed,n_trees,n_features,depth", [(0, 30, 25, 4), (3, 12, 10, 3), (7, 45, 25, 6)])
def test_forest_margins_match_jax(rng, seed, n_trees, n_features, depth):
    jf = jforest.synthetic_forest(seed=seed, n_trees=n_trees, n_features=n_features, depth=depth)
    tf = tforest.synthetic_forest(seed=seed, n_trees=n_trees, n_features=n_features, depth=depth)
    X = _features(rng, 64, n_features)
    got = tf.predict_margin(X, device="cpu")
    assert got.dtype == np.float32 and got.shape == (64, jf.n_classes)
    np.testing.assert_allclose(got, jf.predict_margin(X), **TOL)
    np.testing.assert_allclose(got, jf.predict_margin_np(X), **TOL)


def test_forest_ubj_written_by_the_port_loads_in_jax(tmp_path, rng):
    tf = tforest.synthetic_forest(seed=2, n_trees=9, n_features=25)
    tf.base_score = 0.25
    path = tmp_path / "decision_forest.ubj"
    tforest.write_ubj(tf, path)
    assert path.read_bytes() == jforest.encode_ubjson(tforest.parse_ubjson(path.read_bytes()))
    jf = jforest.Forest.from_ubj(path)
    for name in ("feature", "threshold", "left", "right", "is_leaf", "value", "default_left", "tree_class"):
        np.testing.assert_array_equal(getattr(jf, name), getattr(tf, name), err_msg=name)
    assert (jf.n_classes, jf.max_depth, jf.base_score, jf.n_features) == (tf.n_classes, tf.max_depth, tf.base_score, tf.n_features)
    X = _features(rng, 16, 25)
    np.testing.assert_allclose(tforest.Forest.from_ubj(path).predict_margin(X, device="cpu"), jf.predict_margin(X), **TOL)


def test_forest_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tforest.synthetic_forest().predict_margin(np.zeros((2, 25), np.float32))


@pytest.mark.parametrize("lengths", [(3, 8, 1, 5), (1,), (40, 2, 17), (2, 2)])
def test_crf_batch_matches_jax(rng, lengths):
    spm_v = [rng.uniform(0, 1, n) for n in lengths]
    spm_c = [rng.uniform(0, 1, n) for n in lengths]
    got = tcrf.score_provirus_genes_batch(spm_v, spm_c, device="cpu")
    ref = jcrf.score_provirus_genes_batch(spm_v, spm_c)
    assert [len(g) for g in got] == list(lengths)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **TOL)


def test_crf_single_contig_matches_jax(rng):
    for n in (0, 1, 2, 9):
        v, c = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
        got = tcrf.score_provirus_genes(v, c, device="cpu")
        np.testing.assert_allclose(got, jcrf.score_provirus_genes(v, c), **TOL)
    assert tcrf.score_provirus_genes_batch([], [], device="cpu") == []
    # a single gene has no transitions: its background marginal is exactly 0.5
    one = tcrf.score_provirus_genes([0.0], [0.0], device="cpu")
    np.testing.assert_allclose(one, [0.5], **TOL)


def test_crf_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcrf.score_provirus_genes_batch([[0.1]], [[0.2]])
