"""Weight persistence for the IGLOO classifier.

Copied from ``genomad_tpu/models/weights.py``; reads this package's data
directory. Three sources, in order of preference
(genomad_torch.paths.GenomadData):
  1. ``nn_classifier.npz``  — our native flat-key format (fast, canonical).
  2. ``nn_classifier.h5``   — the reference's Keras checkpoint
     (genomad/modules/nn_classification.py:309-310 loads it with
     ``model.load_weights``); converted on first use.
  3. deterministic synthetic weights — tests/benchmarks only.

The Keras -> pytree mapping is shape- and name-driven rather than a fixed
path list so it tolerates the layer-name suffixes Keras generates
("conv1d", "conv1d_1", ...).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from genomad_torch import utils
from genomad_torch.models import igloo

# Flat npz key -> (pytree path)
_FLAT_KEYS = [
    "conv1/kernel", "conv1/bias",
    "igloo1/patches", "igloo1/w_mult", "igloo1/w_summer", "igloo1/w_bias", "igloo1/w_qk", "igloo1/w_v",
    "conv2/kernel", "conv2/bias",
    "conv3/kernel", "conv3/bias",
    "igloo2/patches", "igloo2/w_mult", "igloo2/w_summer", "igloo2/w_bias", "igloo2/w_qk", "igloo2/w_v",
    "enc_dense/kernel", "enc_dense/bias",
    "enc_bn/gamma", "enc_bn/beta", "enc_bn/mean", "enc_bn/var",
    "head_dense/kernel", "head_dense/bias",
    "head_bn/gamma", "head_bn/beta", "head_bn/mean", "head_bn/var",
    "out_dense/kernel", "out_dense/bias",
]


def save_npz(params: igloo.Params, path: Path) -> None:
    flat = {}
    for key in _FLAT_KEYS:
        group, name = key.split("/")
        flat[key] = np.asarray(params[group][name])
    np.savez_compressed(path, **flat)


def load_npz(path: Path) -> igloo.Params:
    params: igloo.Params = {}
    with np.load(path) as npz:
        for key in _FLAT_KEYS:
            group, name = key.split("/")
            params.setdefault(group, {})[name] = npz[key]
    _validate(params)
    return params


def _validate(params: igloo.Params) -> None:
    expect = {
        "conv1/kernel": (igloo.CONV_KERNEL, igloo.VOCAB, igloo.CHANNELS),
        "conv2/kernel": (igloo.CONV_KERNEL, igloo.CHANNELS, igloo.CHANNELS),
        "conv3/kernel": (igloo.CONV_KERNEL, igloo.CHANNELS, igloo.CHANNELS),
        "igloo1/w_qk": (igloo.N_PATCHES, igloo.POOLED_LEN),
        "igloo2/w_qk": (igloo.N_PATCHES, igloo.POOLED_LEN),
        "enc_dense/kernel": (2 * igloo.CHANNELS, igloo.ENC_DIM),
        "head_dense/kernel": (igloo.ENC_DIM, igloo.ENC_DIM),
        "out_dense/kernel": (igloo.ENC_DIM, igloo.N_CLASSES),
    }
    for key, shape in expect.items():
        group, name = key.split("/")
        got = tuple(params[group][name].shape)
        if got != shape:
            raise ValueError(f"weight {key} has shape {got}, expected {shape}")


# ---------------------------------------------------------------------------
# Keras HDF5 conversion
# ---------------------------------------------------------------------------


def _walk_h5(group, prefix=""):
    import h5py

    for key, item in group.items():
        path = f"{prefix}/{key}"
        if isinstance(item, h5py.Dataset):
            yield path, np.asarray(item)
        else:
            yield from _walk_h5(item, path)


def load_keras_h5(path: Path) -> igloo.Params:
    """Convert the reference Keras checkpoint into our parameter pytree.

    Handles every layout Keras produces for this graph (validated live
    against checkpoints written by the reference's own ``create_classifier``
    under Keras 3 — see tests/test_keras_parity.py for the JAX package):

      * legacy whole-model ``.h5``      (``/model_weights/<layer>/.../kernel``)
      * legacy weights-only ``.h5``     (``/<layer>/.../kernel:0``)
      * Keras 3 ``.weights.h5``         (``/layers/<layer>/vars/<i>`` — anonymous)

    Routing is STRUCTURE-driven, not name-order-driven: datasets are
    grouped by their parent h5 group (one group per layer), layers are
    identified by the multiset of array shapes they contain, kernel/bias
    pairs stay siblings, and the encoder-vs-head ambiguity (two Dense(512)
    + BatchNorm pairs with identical shapes) is resolved by subtree: the
    encoder's pair lives in the nested-model subtree that also holds the
    (6, 257, 128) first conv. Name order alone would swap them — the head
    layer "batch_normalization_1" sorts before "functional/batch_normalization".
    """
    import h5py

    with h5py.File(path, "r") as f:
        datasets = {
            p: a for p, a in _walk_h5(f) if "optimizer" not in p.lower()
        }
    if not datasets:
        raise ValueError(f"no weight datasets found in {path}")

    C, V, K = igloo.CHANNELS, igloo.VOCAB, igloo.CONV_KERNEL
    P, S, L8 = igloo.N_PATCHES, igloo.PATCH_SIZE, igloo.POOLED_LEN
    E, N = igloo.ENC_DIM, igloo.N_CLASSES

    # Group datasets by parent h5 group = one group per Keras layer.
    layers: dict[str, dict[str, np.ndarray]] = {}
    for p, a in datasets.items():
        parent, leaf = p.rsplit("/", 1)
        layers.setdefault(parent, {})[leaf] = a

    def shape_sig(arrays):
        return tuple(sorted(tuple(a.shape) for a in arrays.values()))

    def find_layers(*shapes):
        sig = tuple(sorted(shapes))
        return [g for g in utils.natsort(list(layers)) if shape_sig(layers[g]) == sig]

    def kernel_bias(group, kshape):
        arrays = layers[group]
        kernel = next(a for a in arrays.values() if tuple(a.shape) == kshape)
        bias = next(a for a in arrays.values() if a.ndim == 1)
        # Disambiguate by name when present (legacy layouts name them).
        for leaf, a in arrays.items():
            if "kernel" in leaf.lower():
                kernel = a
            elif "bias" in leaf.lower():
                bias = a
        return {"kernel": kernel, "bias": bias}

    def one(hits, what):
        if len(hits) != 1:
            raise ValueError(f"expected exactly one {what} layer, found {len(hits)}: {hits}")
        return hits[0]

    conv1_group = one(find_layers((C,), (K, V, C)), "first conv")
    conv_rest = find_layers((C,), (K, C, C))
    if len(conv_rest) != 2:
        raise ValueError(f"expected 2 inner conv layers, found {len(conv_rest)}")

    igloo_groups = find_layers((P, S, 1), (1, P, S, C), (1, S * C, 1), (1, P), (P, L8), (1, C, C))
    if len(igloo_groups) != 2:
        raise ValueError(f"expected 2 IGLOO kernel layers, found {len(igloo_groups)}")

    def igloo_params(group):
        def by_shape(shape):
            return next(a for a in layers[group].values() if tuple(a.shape) == shape)

        return {
            "patches": by_shape((P, S, 1)).reshape(P, S).astype(np.int32),
            "w_mult": by_shape((1, P, S, C))[0],
            "w_summer": by_shape((1, S * C, 1))[0, :, 0],
            "w_bias": by_shape((1, P))[0],
            "w_qk": by_shape((P, L8)),
            "w_v": by_shape((1, C, C))[0],
        }

    # Encoder subtree = deepest path prefix shared with the first conv's
    # nested-model group; the encoder Dense(512)+BN pair lives under it,
    # the classifier-head pair does not.
    def subtree_depth(group):
        a, b = group.split("/"), conv1_group.split("/")
        d = 0
        while d < min(len(a), len(b)) and a[d] == b[d]:
            d += 1
        return d

    enc_dense_group = one(find_layers((E,), (2 * C, E)), "encoder dense")
    head_dense_group = one(find_layers((E,), (E, E)), "head dense")
    out_dense_group = one(find_layers((N,), (E, N)), "output dense")

    bn_groups = find_layers((E,), (E,), (E,), (E,))
    if len(bn_groups) != 2:
        raise ValueError(f"expected 2 batchnorm layers, found {len(bn_groups)}")
    # The encoder BN shares a (strictly deeper) subtree with conv1.
    bn_groups.sort(key=subtree_depth, reverse=True)
    enc_bn_group, head_bn_group = bn_groups
    if subtree_depth(enc_bn_group) == subtree_depth(head_bn_group):
        raise ValueError(
            "cannot separate encoder/head batchnorm layers by subtree: "
            f"{enc_bn_group} vs {head_bn_group}"
        )

    def bn_params(group):
        arrays = layers[group]
        named = {leaf.lower().rstrip(":0"): a for leaf, a in arrays.items()}
        for key, words in (("gamma", "gamma"), ("beta", "beta"), ("mean", "moving_mean"), ("var", "moving_variance")):
            hit = [a for leaf, a in named.items() if words in leaf]
            if len(hit) == 1:
                named[key] = hit[0]
        if all(k in named for k in ("gamma", "beta", "mean", "var")):
            return {k: named[k] for k in ("gamma", "beta", "mean", "var")}
        # Anonymous Keras 3 vars: creation order is gamma, beta,
        # moving_mean, moving_variance (trainable weights first).
        ordered = [arrays[k] for k in utils.natsort(list(arrays))]
        return dict(zip(("gamma", "beta", "mean", "var"), ordered))

    params = {
        "conv1": kernel_bias(conv1_group, (K, V, C)),
        "igloo1": igloo_params(igloo_groups[0]),
        "conv2": kernel_bias(conv_rest[0], (K, C, C)),
        "conv3": kernel_bias(conv_rest[1], (K, C, C)),
        "igloo2": igloo_params(igloo_groups[1]),
        "enc_dense": kernel_bias(enc_dense_group, (2 * C, E)),
        "enc_bn": bn_params(enc_bn_group),
        "head_dense": kernel_bias(head_dense_group, (E, E)),
        "head_bn": bn_params(head_bn_group),
        "out_dense": kernel_bias(out_dense_group, (E, N)),
    }
    _validate(params)
    return params


def load_params(console=None) -> igloo.Params:
    """Load the classifier weights from the best available source."""
    from genomad_torch.paths import GenomadData

    if GenomadData.nn_params_file.exists():
        return load_npz(GenomadData.nn_params_file)
    if GenomadData.nn_model_file.exists():
        params = load_keras_h5(GenomadData.nn_model_file)
        try:
            save_npz(params, GenomadData.nn_params_file)
        except OSError:  # pragma: no cover - read-only installs
            pass
        return params
    if console is not None:
        console.warning(
            "Trained NN weights not found (nn_classifier.npz / nn_classifier.h5). "
            "Falling back to deterministic synthetic weights — scores will NOT "
            "be meaningful. Install the model weights into genomad_torch/data/."
        )
    return igloo.init_params(seed=0)
