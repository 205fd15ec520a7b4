"""The plain PyTorch versions of the port's kernels (K5 embed_conv, K4
causal_conv, K2 fused_reduce, K3 patch_reduce) against the JAX package: its XLA
formulations and its Pallas kernels in interpret mode, in float32, and the
bf16 rounding points of the convs.

The CUDA kernels themselves cannot run here; chip_smoke.py holds each of
them against these plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from genomad_torch.models import igloo as tig
from genomad_torch.ops import conv, patch_reduce
from genomad_tpu.models import igloo as jig
from genomad_tpu.ops import conv_pallas
from genomad_tpu.ops import patch_reduce as jpr

torch.set_num_threads(2)

# f32 accumulation-order differences only (as tests/test_conv_pallas.py)
CONV_TOL = dict(rtol=2e-5, atol=2e-5)
# f32 tile-matmul vs gather-dot order (as tests/test_patch_reduce.py)
REDUCE_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_embed_conv_plain_matches_jax(rng):
    B, L, C = 4, 64, 128
    tokens = rng.integers(0, 257, (B, L)).astype(np.int32)
    tokens[0, :9] = 0  # N tokens inside the causal edge (t < 5) and after it
    tokens[1, ::7] = 0
    tokens[2, 3] = 0
    kernel = rng.normal(0, 0.2, (6, 257, C)).astype(np.float32)
    bias = rng.normal(0, 0.2, C).astype(np.float32)
    got = conv.embed_conv_plain(_t(tokens), _t(kernel), _t(bias)).numpy()
    xla = jig._leaky_relu(jig._embed_onehot_conv(jnp.asarray(tokens), jnp.asarray(kernel), jnp.asarray(bias)))
    np.testing.assert_allclose(got, np.asarray(xla), **CONV_TOL)
    pallas = conv_pallas.embed_conv(
        jnp.asarray(tokens), jnp.asarray(kernel), jnp.asarray(bias), tile_b=2, tile_l=32, interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(pallas), **CONV_TOL)


@pytest.mark.parametrize("apply_leaky", [True, False])
def test_causal_conv_plain_matches_jax(rng, apply_leaky):
    B, L, C = 4, 64, 128
    x = rng.normal(0, 1, (B, L, C)).astype(np.float32)
    kernel = rng.normal(0, 0.2, (6, C, C)).astype(np.float32)
    bias = rng.normal(0, 0.2, C).astype(np.float32)
    got = conv.causal_conv_plain(_t(x), _t(kernel), _t(bias), apply_leaky=apply_leaky).numpy()
    xla = jig._causal_conv(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    if apply_leaky:
        xla = jig._leaky_relu(xla)
    np.testing.assert_allclose(got, np.asarray(xla), **CONV_TOL)
    pallas = conv_pallas.causal_conv(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), tile_b=2, tile_l=32,
        apply_leaky=apply_leaky, interpret=True,
    )
    np.testing.assert_allclose(got, np.asarray(pallas), **CONV_TOL)


def test_convs_round_like_jax_in_bf16(rng):
    """The bf16 rounding points (conv result, + bias, LeakyReLU, each in
    bf16) are JAX's: the gather-sum of conv1 is exact, so it is bit-equal;
    conv2's f32 sums differ in order, so its result may round to the
    neighbouring bf16 value before the bias add: one step of at most 2^-7 of
    that value's magnitude, which is at most |output| + |bias|."""
    B, L, C = 4, 64, 128
    tokens = rng.integers(0, 257, (B, L)).astype(np.int32)
    tokens[0, :9] = 0
    k1 = rng.normal(0, 0.2, (6, 257, C)).astype(np.float32)
    k4 = rng.normal(0, 0.2, (6, C, C)).astype(np.float32)
    bias = rng.normal(0, 0.2, C).astype(np.float32)
    x = rng.normal(0, 1, (B, L, C)).astype(np.float32)
    bf = jnp.bfloat16

    def as_np(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    h1 = conv.embed_conv_plain(_t(tokens), _t(k1).bfloat16(), _t(bias).bfloat16())
    h1_ref = jig._leaky_relu(jig._embed_onehot_conv(jnp.asarray(tokens), jnp.asarray(k1, bf), jnp.asarray(bias, bf)))
    np.testing.assert_array_equal(h1.float().numpy(), as_np(h1_ref))
    h2 = conv.causal_conv_plain(_t(x).bfloat16(), _t(k4).bfloat16(), _t(bias).bfloat16())
    h2_ref = jig._leaky_relu(jig._causal_conv(jnp.asarray(x, bf), jnp.asarray(k4, bf), jnp.asarray(bias, bf)))
    np.testing.assert_allclose(h2.float().numpy(), as_np(h2_ref), rtol=2**-7, atol=2**-7 * np.abs(bias).max())


def test_fused_reduce_plain_matches_pallas(rng):
    """Full-size plan of init_params at B=2, f32."""
    params = jig.init_params(seed=3)
    prepared = jig.prepare_params(params, compute_dtype=jnp.float32)
    plan, p = prepared["igloo1_plan"], prepared["igloo1"]
    B = 2
    y = rng.normal(size=(B, jig.L_PAD, jig.CHANNELS)).astype(np.float32)
    mpi_ref, pooled_ref = jpr.fused_reduce(
        jnp.asarray(y), plan["w_tiles"], plan["onehot"], plan["idx"], p["w_v"], interpret=True
    )
    ours = tig.params_from_numpy(params, torch.float32)["igloo1"]
    mpi, pooled = patch_reduce.fused_reduce_plain(_t(y), ours["patches"], ours["w_patch"], ours["w_v"])
    assert mpi.dtype == torch.float32 and mpi.shape == (B, jig.N_PATCHES)
    assert pooled.shape == (B, jig.L_PAD // jig.POOL, jig.CHANNELS)
    np.testing.assert_allclose(mpi.numpy(), np.asarray(mpi_ref), **REDUCE_TOL)
    n = jig.POOLED_LEN
    np.testing.assert_allclose(pooled[:, :n].numpy(), np.asarray(pooled_ref)[:, :n], **REDUCE_TOL)


def test_patch_reduce_plain_matches_pallas(rng):
    """K3: the full-size plan of init_params (2,100 patches, L_PAD 6016,
    C 128) at B=2, f32, against JAX's Pallas ``patch_reduce`` in interpret
    mode; and the plain K3 mpi is the plain K2 mpi exactly."""
    params = jig.init_params(seed=5)
    prepared = jig.prepare_params(params, compute_dtype=jnp.float32)
    plan = prepared["igloo2_plan"]
    B = 2
    y = rng.normal(size=(B, jig.L_PAD, jig.CHANNELS)).astype(np.float32)
    ref = jpr.patch_reduce(jnp.asarray(y), plan["w_tiles"], plan["onehot"], plan["idx"], interpret=True)
    ours = tig.params_from_numpy(params, torch.float32)["igloo2"]
    mpi = patch_reduce.patch_reduce_plain(_t(y), ours["patches"], ours["w_patch"])
    assert mpi.dtype == torch.float32 and mpi.shape == (B, jig.N_PATCHES)
    np.testing.assert_allclose(mpi.numpy(), np.asarray(ref), **REDUCE_TOL)
    for dtype in (torch.float32, torch.bfloat16):
        yt, wp = _t(y).to(dtype), ours["w_patch"].to(dtype)
        fused_mpi, _ = patch_reduce.fused_reduce_plain(yt, ours["patches"], wp, ours["w_v"].to(dtype))
        assert torch.equal(patch_reduce.patch_reduce_plain(yt, ours["patches"], wp), fused_mpi)


def test_fused_reduce_plain_ragged_length(rng):
    """A length that is no multiple of the pool: 'valid' pooling drops the tail."""
    B, L, C, P = 3, 61, 8, 5
    y = rng.normal(size=(B, L, C)).astype(np.float32)
    patches = np.stack([np.sort(rng.choice(L, 4, replace=False)) for _ in range(P)]).astype(np.int32)
    w_patch = rng.normal(size=(P, 4, C)).astype(np.float32)
    w_v = rng.normal(size=(C, C)).astype(np.float32)
    mpi, pooled = patch_reduce.fused_reduce_plain(_t(y), _t(patches), _t(w_patch), _t(w_v))
    np.testing.assert_allclose(mpi.numpy(), np.einsum("bpsc,psc->bp", y[:, patches], w_patch), rtol=1e-5, atol=1e-5)
    proj = (y[:, :56] @ w_v).reshape(B, 7, 8, C).max(2)
    np.testing.assert_allclose(pooled.numpy(), proj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(chip_smoke.FUSED_EDGE_CASES))
def test_fused_reduce_edge_cases_match_jax(name):
    """The edge cases of K2/K3's persistent schedule (one tile plus a ragged
    one, more batch rows than blocks, no pool window, a ragged length, every
    slot in the first tile), first two batch rows, f32: the plain versions
    against JAX's Pallas ``fused_reduce`` in interpret mode where L is a
    multiple of its 128-row tile, else against the einsum formula; the plain
    K3 mpi is the plain K2 mpi exactly. chip_smoke.py's kernel phase holds
    the kernels against the plain versions on every row, f32 and bf16."""
    y, patches, w_patch, w_v = chip_smoke.fused_reduce_edge_cases(max_rows=2)[name]
    B, L, C = y.shape
    mpi, pooled = patch_reduce.fused_reduce_plain(_t(y), _t(patches), _t(w_patch), _t(w_v))
    assert mpi.shape == (B, 2100) and pooled.shape == (B, L // 8, C)
    assert torch.equal(patch_reduce.patch_reduce_plain(_t(y), _t(patches), _t(w_patch)), mpi)
    if L % jpr.TILE == 0:
        plan = jpr.build_plan(patches, w_patch, L)
        mpi_ref, pooled_ref = jpr.fused_reduce(
            jnp.asarray(y), plan.w_tiles, plan.onehot, plan.idx, jnp.asarray(w_v), interpret=True
        )
    else:
        mpi_ref = np.einsum("bpsc,psc->bp", y[:, patches], w_patch)
        n = L // 8 * 8
        pooled_ref = (y[:, :n] @ w_v).reshape(B, L // 8, 8, C).max(2)
    np.testing.assert_allclose(mpi.numpy(), np.asarray(mpi_ref), **REDUCE_TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_ref), **REDUCE_TOL)


def _table_cases():
    edge = chip_smoke.fused_reduce_edge_cases(max_rows=1)
    return {
        "init_params": (tig.init_params(0)["igloo1"]["patches"], tig.L_PAD),
        "fullest_tile": (edge["fullest_tile"][1], 6016),
        "L1001": (edge["B3_L1001"][1], 1001),  # no multiple of 64
    }


@pytest.mark.parametrize("case", ["init_params", "fullest_tile", "L1001"])
def test_slot_table_lists_each_slot_once_by_tile(case, rng):
    patches, L = _table_cases()[case]
    P, S = patches.shape
    n_tiles = -(-L // 64)
    w_patch = rng.normal(size=(P, S, 16)).astype(np.float32)
    index, weights = patch_reduce.slot_table(_t(patches), _t(w_patch), n_tiles)
    index = index.numpy()
    assert index.dtype == np.int32 and index.shape == (n_tiles + 1 + P * S,)
    start, entries = index[: n_tiles + 1], index[n_tiles + 1 :]
    assert start[0] == 0 and start[-1] == P * S and (np.diff(start) >= 0).all()
    ids, rows = entries // 64, entries % 64
    np.testing.assert_array_equal(np.sort(ids), np.arange(P * S))  # each (p, s) once
    flat = patches.reshape(-1)
    for t in range(n_tiles):
        k = slice(start[t], start[t + 1])
        np.testing.assert_array_equal(flat[ids[k]], t * 64 + rows[k])  # the slot's own position, in tile t
    key = flat[ids] * (P * S) + ids
    assert (np.diff(key) > 0).all()  # by position, then (p, s)
    assert (flat[ids] < L).all()
    # the weights: channels 8c..8c+7 of entry k's w_patch row at [c, k]
    assert weights.shape == (2, P * S, 8) and weights.is_contiguous()
    np.testing.assert_array_equal(weights.numpy(), w_patch.reshape(P * S, 2, 8)[ids].transpose(1, 0, 2))
    # the default tile count ends at the last tile that holds a slot
    default = patch_reduce.slot_table(_t(patches), _t(w_patch)).index.numpy()
    n_last = int(patches.max()) // 64 + 1
    np.testing.assert_array_equal(default, np.concatenate([start[: n_last + 1], entries]))


@pytest.mark.parametrize("case", ["init_params", "fullest_tile"])
def test_slot_dots_through_the_table_equal_the_plain_bits(case, rng):
    """One dot per slot, evaluated through the table as the kernel reads it
    (tile t's row 64 t + row against the table's weights), summed over each
    patch's slots in s order: the plain version's mpi bit for bit, f32 and
    bf16."""
    patches, L = _table_cases()[case]
    P, S = patches.shape
    n_tiles = -(-L // 64)
    y = _t(rng.normal(size=(2, L, 16)).astype(np.float32))
    w_patch = _t(rng.normal(size=(P, S, 16)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        yt, wt = y.to(dtype), w_patch.to(dtype)
        index, weights = patch_reduce.slot_table(_t(patches), wt, n_tiles)
        start, entries = index[: n_tiles + 1], index[n_tiles + 1 :].long()
        tile_of = torch.repeat_interleave(torch.arange(n_tiles), torch.diff(start.long()))
        ids, pos = entries // 64, tile_of * 64 + entries % 64
        rows = weights.transpose(0, 1).reshape(P * S, 16)  # entry k's w_patch row
        dots = torch.empty((2, P * S))
        dots[:, ids] = (yt[:, pos].float() * rows.float()).sum(-1)
        dots = dots.view(2, P, S)
        mpi = dots[..., 0]
        for s in range(1, S):
            mpi = mpi + dots[..., s]
        assert torch.equal(mpi, patch_reduce.patch_reduce_plain(yt, _t(patches), wt))


def test_kernel_checks_of_the_bf16_body():
    """The bf16 body's own checks (the CPU path is taken first, so they are
    called directly): a slot table of another type, size or dtype, and more
    slots than a block keeps in shared memory; the other bodies read no
    table."""
    y = torch.zeros((2, 70, 128), dtype=torch.bfloat16)
    patches = torch.zeros((7, 4), dtype=torch.int32)
    w_patch = torch.zeros((7, 4, 128), dtype=torch.bfloat16)
    index, weights = patch_reduce.slot_table(patches, w_patch, 2)
    assert patch_reduce._slots_for(y, patches, w_patch, (index, weights))[2] == 2
    assert patch_reduce._slots_for(y, patches, w_patch, None)[2] == 2  # built for L = 70
    assert patch_reduce._slots_for(y.float(), patches, w_patch.float(), None) == (0, 0, 0)
    for bad in ((index.long(), weights), (index[:20], weights), (index, weights.float()), (index, weights[:, :20])):
        with pytest.raises(ValueError, match="slots must be"):
            patch_reduce._slots_for(y, patches, w_patch, bad)
    with pytest.raises(ValueError, match="P \\* S <="):
        patch_reduce._check_tc(y, patch_reduce.MAX_SLOTS // 4 + 1, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        patch_reduce._check_tc(torch.zeros(2 * 70 * 128 + 1, dtype=torch.bfloat16)[1:].view(2, 70, 128), 7, 4)
    patch_reduce._check_tc(y, 7, 4)


def _wrapper_cases(rng):
    tokens = _t(rng.integers(0, 257, (2, 40)).astype(np.int32))
    k1 = _t(rng.normal(0, 0.2, (6, 257, 16)).astype(np.float32))
    x = _t(rng.normal(0, 1, (2, 40, 16)).astype(np.float32))
    k4 = _t(rng.normal(0, 0.2, (6, 16, 16)).astype(np.float32))
    bias = _t(rng.normal(0, 0.2, 16).astype(np.float32))
    patches = _t(np.sort(rng.choice(40, (7, 4)), axis=1).astype(np.int32))
    w_patch = _t(rng.normal(size=(7, 4, 16)).astype(np.float32))
    return {
        "embed_conv": (conv.embed_conv, conv.embed_conv_plain, (tokens, k1, bias)),
        "causal_conv": (conv.causal_conv, conv.causal_conv_plain, (x, k4, bias)),
        "fused_reduce": (patch_reduce.fused_reduce, patch_reduce.fused_reduce_plain, (x, patches, w_patch, k4[0])),
        "patch_reduce": (patch_reduce.patch_reduce, patch_reduce.patch_reduce_plain, (x, patches, w_patch)),
    }


@pytest.mark.parametrize("name", ["embed_conv", "causal_conv", "fused_reduce", "patch_reduce"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_takes_the_plain_version(rng, name, dtype):
    wrapper, plain, args = _wrapper_cases(rng)[name]
    args = tuple(a if a.dtype == torch.int32 else a.to(dtype) for a in args)
    before = wrapper.launches
    got, ref = wrapper(*args), plain(*args)
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        assert g.dtype == r.dtype
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert wrapper.launches == before  # no kernel launch on the CPU


def test_patch_reduce_checks_its_inputs(rng):
    """K3 makes K2's checks before it launches (here the CPU path is taken
    first, so the checks are called directly)."""
    y = torch.zeros((2, 40, 16))
    patches = torch.zeros((7, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="w_patch must be"):
        patch_reduce._check(y, patches, torch.zeros((7, 3, 16)))
    with pytest.raises(ValueError, match="patches must be"):
        patch_reduce._check(y, patches.long(), torch.zeros((7, 4, 16)))
    with pytest.raises(ValueError, match="share a float32 or bfloat16"):
        patch_reduce._check(y, patches, torch.zeros((7, 4, 16), dtype=torch.bfloat16))
    assert patch_reduce._check(y, patches, torch.zeros((7, 4, 16))) == (2, 40, 16, 7, 4)


def _k4_inputs(C=16, dtype=torch.float32):
    return torch.zeros((2, 40, C), dtype=dtype), torch.zeros((6, C, C), dtype=dtype), torch.zeros(C, dtype=dtype)


@pytest.mark.parametrize(
    "case, match",
    [
        (lambda: _k4_inputs(C=64, dtype=torch.bfloat16), "bf16 kernel takes C = 128"),
        (lambda: (*_k4_inputs()[:2], torch.zeros(16, dtype=torch.bfloat16)), "share a float32 or bfloat16"),
        (lambda: (_k4_inputs()[0].transpose(0, 1), *_k4_inputs()[1:]), "must be contiguous"),
        (lambda: (_k4_inputs()[0], torch.zeros((5, 16, 16)), _k4_inputs()[2]), r"must be \(6, C, C\)"),
        (lambda: (_k4_inputs()[0], torch.zeros((6, 16, 8)), _k4_inputs()[2]), r"must be \(6, C, C\)"),
        (
            lambda: (torch.zeros(2 * 40 * 128 + 1, dtype=torch.bfloat16)[1:].view(2, 40, 128),
                     *_k4_inputs(C=128, dtype=torch.bfloat16)[1:]),
            "16-byte aligned",
        ),
    ],
    ids=["bf16-C64", "mixed-dtypes", "non-contiguous-x", "five-taps", "not-square", "bf16-misaligned-x"],
)
def test_causal_conv_checks_its_inputs(case, match):
    """K4 makes these checks before it launches and raises on what the kernel
    does not take (here the CPU path is taken first, so the checks are
    called directly)."""
    with pytest.raises(ValueError, match=match):
        conv._check(*case())


def test_causal_conv_check_passes_what_the_kernel_takes():
    assert conv._check(*_k4_inputs(C=128, dtype=torch.bfloat16)) == (2, 40, 128)
    assert conv._check(*_k4_inputs(C=332)) == (2, 40, 332)


def test_k4_ablations_edit_the_committed_kernel():
    """The ablation tool edits lines of csrc/causal_conv.cu: each of its
    kernels differs from the committed one, and an edit that no longer
    matches raises instead of timing the unedited kernel."""
    from genomad_torch.ops import _build
    from genomad_torch.tools import ablate_causal_conv as ab

    source = (_build.CSRC / "causal_conv.cu").read_text()
    sources = ab.ablated_sources(source)
    assert sources["kernel"] == source
    assert len({sources[name] for name in ab.ABLATIONS}) == len(ab.ABLATIONS)
    with pytest.raises(ValueError, match="expected one"):
        ab.ablated_sources(source.replace("wgmma_m64n128k16(d, da, db, k | kk);", ""))
