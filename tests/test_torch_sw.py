"""K1 (Smith-Waterman) of the port on the CPU: the plain PyTorch version
(``ops.sw.sw_forward_plain`` / ``sw_pairs_plain``) and ``sw_align`` against
the JAX package's ``_sw_forward`` (the oracle), its staged-bucket programs
``_sw_fwd_gate`` / ``_sw_rev_cov``, its ``sw_align`` and one Pallas tiling
in interpret mode; and the port's f32 E-value gate against ``_gate_ev``.

The CUDA kernel itself cannot run here; chip_smoke.py holds it against
``sw_pairs_plain`` on the card, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomad_torch.ops import protein_search as tps
from genomad_torch.ops import sw
from genomad_tpu.ops import protein_search as jps
from genomad_tpu.ops import sw_pallas
from genomad_tpu.ops.profiledb import N_AA
from tests.test_sw_pallas import make_batch

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ulps(a, b):
    """Distance in f32 units in the last place (non-negative values)."""
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64) - b.astype(np.float32).view(np.int32))


def _jax_forward(q, p):
    return tuple(np.asarray(x) for x in jps._sw_forward(jnp.asarray(q), jnp.asarray(p)))


def _gapped_batch(rng, B=4, Lq=40, Lp=48):
    """Queries that need internal gaps on both sides: profile consensus
    with residues deleted (gap in the query) or inserted (gap in the
    profile)."""
    queries = np.full((B, Lq), 20, np.int32)
    profiles = np.zeros((B, Lp, 21), np.float32)
    for b in range(B):
        lp = int(rng.integers(30, Lp + 1))
        cons = rng.integers(0, N_AA, lp)
        pssm = rng.normal(-1.5, 1.0, (lp, N_AA)).astype(np.float32)
        pssm[np.arange(lp), cons] += rng.uniform(4, 8, lp)
        if b % 2:
            q = np.delete(cons, [10, 11, 12])
        else:
            q = np.insert(cons, 15, rng.integers(0, N_AA, 4))
        q = q[:Lq]
        queries[b, : len(q)] = q
        profiles[b, :lp, :N_AA] = pssm
    return queries, profiles


def _batch(rng, kind):
    if kind == "float":
        return make_batch(rng, B=6, Lq=32, Lp=48)
    if kind == "ragged":
        return make_batch(rng, B=13, Lq=37, Lp=61)
    if kind == "gapped":
        return _gapped_batch(rng)
    q, p = make_batch(rng, B=9, Lq=40, Lp=50)  # integral
    return q, np.round(p)


@pytest.mark.parametrize("kind", ["float", "ragged", "gapped", "integral"])
def test_sw_forward_plain_matches_jax(rng, kind):
    q, p = _batch(rng, kind)
    ref_best, ref_i, ref_j = _jax_forward(q, p)
    best, end_i, end_j = (x.numpy() for x in sw.sw_forward_plain(_t(q), _t(p)))
    assert best.dtype == np.float32 and end_i.dtype == np.int32 and end_j.dtype == np.int32
    np.testing.assert_array_equal(end_i, ref_i)
    np.testing.assert_array_equal(end_j, ref_j)
    if kind == "integral":
        np.testing.assert_array_equal(best, ref_best)
    else:
        np.testing.assert_allclose(best, ref_best, rtol=1e-5)
    assert (ref_best > 0).all()  # every pair aligns something


def test_sw_plain_matches_pallas_interpret(rng):
    q, p = make_batch(rng, B=5)
    got = sw.sw_forward_plain(_t(q), _t(p))
    ref = sw_pallas.sw_forward_pallas(jnp.asarray(q), jnp.asarray(p), tile_b=4, interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def _staged(rng, nq=12, n_prof=10, Lq=64, Lp=96, integral=True):
    """A staged query bucket, a staged profile bucket (zero padding rows
    and column 20), real lengths, and pairs drawn from both with planted
    partial matches."""
    all_q = np.full((nq, Lq), 20, np.int32)
    all_p = np.zeros((n_prof, Lp, 21), np.float32)
    q_len = rng.integers(8, Lq + 1, nq).astype(np.int32)
    p_len = rng.integers(10, Lp + 1, n_prof).astype(np.int32)
    for i in range(n_prof):
        x = rng.normal(-2.0, 0.7, (p_len[i], N_AA))
        x[np.arange(p_len[i]), rng.integers(0, N_AA, p_len[i])] += rng.uniform(5, 9, p_len[i])
        all_p[i, : p_len[i], :N_AA] = np.round(x) if integral else x
    for i in range(nq):
        all_q[i, : q_len[i]] = rng.integers(0, N_AA, q_len[i])
    idx = np.stack([rng.integers(0, nq, 40), rng.integers(0, n_prof, 40)]).astype(np.int32)
    for a, b in idx.T[::3]:
        m = min(q_len[a], p_len[b])
        all_q[a, :m] = all_p[b, :m, :N_AA].argmax(1)
    return all_q, all_p, q_len, p_len, idx


@pytest.mark.parametrize("integral", [True, False])
def test_sw_pairs_plain_matches_jax_gate_and_coverage(rng, integral):
    """Forward pass against ``_sw_fwd_gate`` and reverse pass against
    ``_sw_rev_cov`` on staged buckets (both passes by pair index)."""
    all_q, all_p, q_len, p_len, idx = _staged(rng, integral=integral)
    plen = p_len.astype(np.float32)
    ka = jps.ka_params(jps.KA_LAMBDA, jps.KA_K, int(q_len.sum()))
    ref = np.asarray(jps._sw_fwd_gate(jnp.asarray(all_q), jnp.asarray(all_p), jnp.asarray(plen), jnp.asarray(idx), jnp.asarray(ka)))
    lengths = (_t(q_len), _t(p_len))
    best, end_i, end_j = sw.sw_pairs(_t(all_q), _t(all_p), _t(idx), lengths=lengths)
    np.testing.assert_array_equal(end_i.numpy(), ref[:, 1].astype(np.int32))
    np.testing.assert_array_equal(end_j.numpy(), ref[:, 2].astype(np.int32))
    if integral:
        np.testing.assert_array_equal(best.numpy(), ref[:, 0])
    else:  # XLA compiles the gathered program's f32 sums in another order
        np.testing.assert_allclose(best.numpy(), ref[:, 0], rtol=1e-5)
    ev = tps._gate_ev(best, _t(plen)[idx[1]], _t(ka)).numpy()
    assert _ulps(ev, ref[:, 3]).max() <= 2
    ends = np.stack([end_i.numpy(), end_j.numpy()])
    cov_ref = np.asarray(jps._sw_rev_cov(
        jnp.asarray(all_q), jnp.asarray(all_p), jnp.asarray(plen), jnp.asarray(idx), jnp.asarray(ends.astype(np.float32))
    ))
    rbest, _, rev_j = sw.sw_pairs(_t(all_q), _t(all_p), _t(idx), ends=_t(ends), lengths=lengths)
    cov = (rev_j.float() + 1.0) / _t(plen)[idx[1]]
    np.testing.assert_array_equal(cov.numpy(), cov_ref)
    # the reverse pass rescores the same alignment (sums in reverse order)
    np.testing.assert_allclose(rbest.numpy(), best.numpy(), rtol=0 if integral else 1e-5)


def test_sw_forward_stops_at_real_lengths_unchanged(rng):
    """K1 stops at each pair's real lengths: the plain version on the
    pair's unpadded operands gives the padded bucket's result."""
    all_q, all_p, q_len, p_len, idx = _staged(rng)
    full = sw.sw_pairs_plain(_t(all_q), _t(all_p), _t(idx))
    for k, (a, b) in enumerate(idx.T):
        q = _t(all_q[a : a + 1, : q_len[a]])
        p = _t(all_p[b : b + 1, : p_len[b]])
        got = sw.sw_forward_plain(q, p)
        assert [float(got[0][0]), int(got[1][0]), int(got[2][0])] == [float(full[0][k]), int(full[1][k]), int(full[2][k])]


@pytest.mark.parametrize("compute_starts", [False, True])
def test_sw_align_matches_jax(rng, compute_starts):
    q, p = make_batch(rng, B=7, Lq=40, Lp=56)
    ref = jps.sw_align(q, p[:, :, :N_AA], compute_starts=compute_starts)
    got = sw.sw_align(q, p[:, :, :N_AA], compute_starts=compute_starts, device="cpu")
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)


def test_sw_align_without_device_raises_without_cuda(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    q, p = make_batch(rng, B=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sw.sw_align(q, p[:, :, :N_AA])


def test_sw_pairs_cpu_takes_the_plain_version(rng):
    all_q, all_p, q_len, p_len, idx = _staged(rng)
    counts = (sw.sw_pairs.launches, sw.sw_pairs.forward_launches, sw.sw_pairs.reverse_launches)
    got = sw.sw_pairs(_t(all_q), _t(all_p), _t(idx), lengths=(_t(q_len), _t(p_len)))
    ref = sw.sw_pairs_plain(_t(all_q), _t(all_p), _t(idx))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    ends = torch.stack([got[1], got[2]])
    sw.sw_pairs(_t(all_q), _t(all_p).bfloat16(), _t(idx), ends=ends)  # bf16 staging is accepted
    assert (sw.sw_pairs.launches, sw.sw_pairs.forward_launches, sw.sw_pairs.reverse_launches) == counts


def test_gate_matches_jax_bits_and_ulp(rng):
    """The port's f32 E-value gate against JAX's ``_gate_ev``. The port
    takes the operations XLA compiles the JAX gate to (a fused
    multiply-add, then the folded 1/ln 2 and ln 2 multiplies); the E-value
    agrees within two ulps (XLA's f32 exp polynomial against an exp rounded
    from f64, then the product's rounding), and so do the gate decisions at
    fixed thresholds."""
    score = np.concatenate([np.arange(0, 2500, dtype=np.float32), rng.uniform(0, 2500, 20000).astype(np.float32)])
    plen = rng.integers(30, 1000, len(score)).astype(np.float32)
    for n_gate in (1_000, 98_765_432):
        ka = jps.ka_params(jps.KA_LAMBDA, jps.KA_K, n_gate)
        # jitted, as inside the search's _sw_fwd_gate program
        ref = np.asarray(jax.jit(jps._gate_ev)(jnp.asarray(score), jnp.asarray(plen), jnp.asarray(ka)))
        got = tps._gate_ev(_t(score), _t(plen), _t(ka)).numpy()
        assert got.dtype == np.float32
        normal = ref >= np.finfo(np.float32).tiny  # XLA flushes subnormal results to zero
        # one ulp of exp, carried through the last f32 multiply's rounding
        assert _ulps(got, ref)[normal].max() <= 2
        np.testing.assert_array_equal(got[~normal], ref[~normal])  # both flush to zero
        # threshold decisions at the production and a harsh gate
        for thr in (1e-3, 1e-12):
            np.testing.assert_array_equal(got <= np.float32(thr), ref <= np.float32(thr))


def test_calibrate_db_equals_jax():
    """The Karlin-Altschul calibration (null SW scores through sw_align,
    then the Gumbel fit) gives the JAX package's (lambda, K)."""
    from genomad_torch.ops import statistics as tstats
    from genomad_torch.ops.profiledb import ProfileDB as TorchDB
    from genomad_tpu.ops import statistics as jstats
    from genomad_tpu.ops.profiledb import ProfileDB

    jdb = ProfileDB.synthetic(seed=8, n_profiles=12, min_len=40, max_len=90)
    tdb = TorchDB(jdb.names, jdb.lengths, jdb.taxids, jdb.pssm, jdb.offsets)
    kwargs = dict(n_queries=6, query_length=60, profiles_per_query=4, seed=2)
    ref_scores, ref_mn = jstats.sample_null_scores(jdb, **kwargs)
    scores, mn = tstats.sample_null_scores(tdb, device="cpu", **kwargs)
    np.testing.assert_array_equal(scores, ref_scores)
    np.testing.assert_array_equal(mn, ref_mn)
    assert tstats.calibrate_db(tdb, device="cpu", **kwargs) == jstats.calibrate_db(jdb, **kwargs)
    assert (tdb.ka_lambda, tdb.ka_k) == (jdb.ka_lambda, jdb.ka_k)


def test_sw_pairs_refuses_other_devices():
    q = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    p = torch.zeros((2, 8, 21), device="meta")
    idx = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sw.sw_pairs(q, p, idx)
    with pytest.raises(ValueError, match="different devices"):
        sw.sw_pairs(torch.zeros((2, 8), dtype=torch.int32), p, idx)
