"""The port's IGLOO model against the JAX package: synthetic weights, the
parameter folding, the forward pass (tiny width, tiny length and full size)
and the weight files. float32 throughout, on the CPU, where every kernel
runs as its plain PyTorch version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomad_torch.models import igloo as tig
from genomad_torch.models import weights as tweights
from genomad_tpu.models import igloo as jig
from genomad_tpu.models import weights as jweights

torch.set_num_threads(2)

# f32 forward vs the JAX forward (as tests/test_igloo.py:119)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)


def tiny_params(rng, L, C=8, P=16, S=4, ENC=12):
    """Narrow parameter pytree over the full 257-token vocabulary (as
    make_tiny_params of tests/test_igloo.py, with V = 257 so that base codes
    can feed it) for a trunk of length L."""
    pool_len = min(L, jig.WINDOW_TOKENS) // jig.POOL

    def glorot(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.2

    def igloo_kernel():
        patches = np.stack([np.sort(rng.choice(L, size=S, replace=False)) for _ in range(P)]).astype(np.int32)
        return {
            "patches": patches,
            "w_mult": glorot(P, S, C),
            "w_summer": glorot(S * C),
            "w_bias": glorot(P),
            "w_qk": glorot(P, pool_len),
            "w_v": glorot(C, C),
        }

    def bn():
        return {
            "gamma": rng.uniform(0.5, 1.5, ENC).astype(np.float32),
            "beta": glorot(ENC),
            "mean": glorot(ENC),
            "var": rng.uniform(0.5, 1.5, ENC).astype(np.float32),
        }

    return {
        "conv1": {"kernel": glorot(6, jig.VOCAB, C), "bias": glorot(C)},
        "igloo1": igloo_kernel(),
        "conv2": {"kernel": glorot(6, C, C), "bias": glorot(C)},
        "conv3": {"kernel": glorot(6, C, C), "bias": glorot(C)},
        "igloo2": igloo_kernel(),
        "enc_dense": {"kernel": glorot(2 * C, ENC), "bias": glorot(ENC)},
        "enc_bn": bn(),
        "head_dense": {"kernel": glorot(ENC, ENC), "bias": glorot(ENC)},
        "head_bn": bn(),
        "out_dense": {"kernel": glorot(ENC, 3), "bias": glorot(3)},
    }


def random_base_codes(rng, B, n_fraction=0.04):
    """(B, 6000) base codes: random DNA with Ns sprinkled in and one N run."""
    codes = rng.choice(5, size=(B, 6000), p=[(1 - n_fraction) / 4] * 4 + [n_fraction]).astype(np.uint8)
    codes[0, 100:140] = 4
    return codes


def test_constants_match_jax():
    for name in ("WINDOW_TOKENS", "VOCAB", "CHANNELS", "CONV_KERNEL", "N_PATCHES", "PATCH_SIZE", "POOL",
                 "POOLED_LEN", "L_PAD", "ENC_DIM", "N_CLASSES", "BN_EPS"):
        assert getattr(tig, name) == getattr(jig, name), name


@pytest.mark.parametrize("seed", [0, 5])
def test_init_params_bit_equal(seed):
    ours, ref = tig.init_params(seed), jig.init_params(seed)
    assert ours.keys() == ref.keys()
    for group in ref:
        assert ours[group].keys() == ref[group].keys()
        for name in ref[group]:
            assert ours[group][name].dtype == ref[group][name].dtype, (group, name)
            np.testing.assert_array_equal(ours[group][name], ref[group][name], err_msg=f"{group}/{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_params_from_numpy_matches_prepare_params(dtype):
    """Same folding and the same casts as prepare_params: bit-equal."""
    raw = jig.init_params(seed=2)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jig.prepare_params(raw, compute_dtype=jdtype)
    ours = tig.params_from_numpy(raw, dtype)
    for group, tensors in ours.items():
        for name, tensor in tensors.items():
            expect = np.asarray(jnp.asarray(ref[group][name], jnp.float32 if name != "patches" else jnp.int32))
            assert tensor.dtype == (torch.int32 if name == "patches" else dtype), (group, name)
            np.testing.assert_array_equal(tensor.float().numpy() if name != "patches" else tensor.numpy(), expect,
                                          err_msg=f"{group}/{name}")


def test_tiny_forward_tokens_matches_apply(rng):
    """Tiny width and length (L = 64) on the token path (JAX ``apply``)."""
    params = tiny_params(rng, L=64)
    tokens = rng.integers(0, jig.VOCAB, size=(3, 64)).astype(np.int32)
    tokens[1, :6] = 0
    expected = np.asarray(jig.apply(jig.prepare_params(params, jnp.float32), jnp.asarray(tokens)))
    model = tig.IglooClassifier(params, device="cpu", dtype=torch.float32)
    got = model.forward_tokens(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, expected, **FWD_TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_tiny_width_forward_bases_matches_apply_bases(rng):
    """Tiny width at the full window length, through the base-code path."""
    params = tiny_params(rng, L=jig.WINDOW_TOKENS)
    bases = random_base_codes(rng, 3)
    expected = np.asarray(jig.apply_bases(jig.prepare_params(params, jnp.float32), jnp.asarray(bases, jnp.int32)))
    model = tig.IglooClassifier(params, device="cpu", dtype=torch.float32)
    got = model.forward_bases(torch.from_numpy(bases)).numpy()
    np.testing.assert_allclose(got, expected, **FWD_TOL)


def test_full_size_forward_bases_matches_apply_bases(rng):
    """Full size, B = 2: JAX takes its Pallas fused_reduce (interpret mode)."""
    params = jig.init_params(seed=0)
    bases = random_base_codes(rng, 2)
    expected = np.asarray(jig.apply_bases(jig.prepare_params(params, jnp.float32), jnp.asarray(bases, jnp.int32)))
    model = tig.IglooClassifier(tig.init_params(seed=0), device="cpu", dtype=torch.float32)
    with torch.inference_mode():
        got = model.forward_bases(torch.from_numpy(bases))
    assert got.shape == (2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, **FWD_TOL)


def test_forward_rejects_patches_outside_the_trunk(rng):
    params = tiny_params(rng, L=64)
    model = tig.IglooClassifier(params, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="outside a trunk"):
        model.forward_tokens(torch.zeros((1, 32), dtype=torch.int32))
    params["igloo2"]["patches"][3, 0] = -1
    with pytest.raises(ValueError, match=">= 0"):
        tig.IglooClassifier(params, device="cpu", dtype=torch.float32)


def test_npz_round_trip_matches_jax(tmp_path):
    params = tig.init_params(seed=1)
    ours_path, jax_path = tmp_path / "ours.npz", tmp_path / "jax.npz"
    tweights.save_npz(params, ours_path)
    jweights.save_npz(params, jax_path)
    for path in (ours_path, jax_path):
        ours, ref = tweights.load_npz(path), jweights.load_npz(path)
        for group in params:
            for name in params[group]:
                np.testing.assert_array_equal(ours[group][name], ref[group][name])
                np.testing.assert_array_equal(ours[group][name], params[group][name])


def test_load_npz_rejects_wrong_shapes(tmp_path):
    params = tig.init_params(seed=1)
    params["conv2"]["kernel"] = params["conv2"]["kernel"][:5]
    path = tmp_path / "bad.npz"
    tweights.save_npz(params, path)
    with pytest.raises(ValueError, match="conv2/kernel"):
        tweights.load_npz(path)


def _write_keras_like_h5(path, params):
    """A checkpoint laid out as Keras writes the reference model (as in
    tests/test_igloo.py::test_keras_h5_loader)."""
    import h5py

    with h5py.File(path, "w") as f:
        enc = f.create_group("model_weights/functional")
        for i, conv_name in enumerate(["conv1", "conv2", "conv3"]):
            g = enc.create_group("conv1d" if i == 0 else f"conv1d_{i}")
            g.create_dataset("kernel:0", data=params[conv_name]["kernel"])
            g.create_dataset("bias:0", data=params[conv_name]["bias"])
        for i, key in enumerate(["igloo1", "igloo2"]):
            g = enc.create_group("igloo1d_kernel" if i == 0 else "igloo1d_kernel_1")
            g.create_dataset("random_patches:0", data=params[key]["patches"][..., None])
            g.create_dataset("w_mult:0", data=params[key]["w_mult"][None])
            g.create_dataset("w_summer:0", data=params[key]["w_summer"][None, :, None])
            g.create_dataset("w_bias:0", data=params[key]["w_bias"][None])
            g.create_dataset("w_qk:0", data=params[key]["w_qk"])
            g.create_dataset("w_v:0", data=params[key]["w_v"][None])

        def dense_bn(parent, dense, bn, dense_key, bn_key):
            g = parent.create_group(dense)
            g.create_dataset("kernel:0", data=params[dense_key]["kernel"])
            g.create_dataset("bias:0", data=params[dense_key]["bias"])
            g = parent.create_group(bn)
            for name, key in (("gamma", "gamma"), ("beta", "beta"), ("moving_mean", "mean"), ("moving_variance", "var")):
                g.create_dataset(f"{name}:0", data=params[bn_key][key])

        dense_bn(enc, "dense", "batch_normalization", "enc_dense", "enc_bn")
        dense_bn(f["model_weights"], "dense_1", "batch_normalization_1", "head_dense", "head_bn")
        g = f["model_weights"].create_group("dense_2")
        g.create_dataset("kernel:0", data=params["out_dense"]["kernel"])
        g.create_dataset("bias:0", data=params["out_dense"]["bias"])


def test_keras_h5_loader_matches_jax(tmp_path):
    pytest.importorskip("h5py")
    params = tig.init_params(seed=2)
    for group in ("enc_bn", "head_bn"):  # distinct values, so a swap would show
        params[group] = {k: v + np.float32(0.5 if group == "enc_bn" else 0.25) for k, v in params[group].items()}
    path = tmp_path / "nn_classifier.h5"
    _write_keras_like_h5(path, params)
    ours, ref = tweights.load_keras_h5(path), jweights.load_keras_h5(path)
    for group in params:
        for name in params[group]:
            np.testing.assert_array_equal(ours[group][name], ref[group][name], err_msg=f"{group}/{name}")
            np.testing.assert_array_equal(ours[group][name], params[group][name], err_msg=f"{group}/{name}")


def test_load_params_falls_back_to_synthetic_weights():
    from genomad_torch.paths import GenomadData

    if GenomadData.nn_params_file.exists() or GenomadData.nn_model_file.exists():
        pytest.skip("trained weights are installed")
    params = tweights.load_params()
    expected = jig.init_params(seed=0)
    for group in expected:
        for name in expected[group]:
            np.testing.assert_array_equal(params[group][name], expected[group][name])
