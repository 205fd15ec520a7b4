"""The port's search engine (``genomad_torch.ops.protein_search.search`` on
the CPU, K1 through its plain version) returns the same hit table as the
JAX engine's ``search`` on synthetic profile DBs: the stop rule firing, the
profile-coverage gate, the gate's search space, both scheduling modes, the
all-pairs path, the 768/1024 length buckets and the length limit."""

import math

import numpy as np
import pytest
import torch

from genomad_torch.ops import protein_search as tps
from genomad_torch.ops.profiledb import ProfileDB as TorchDB
from genomad_tpu.ops import protein_search as jps
from genomad_tpu.ops.profiledb import ALPHABET, N_AA, ProfileDB
from tests.test_orientation_oracle import _make_db_and_queries

torch.set_num_threads(2)


def _twin(db):
    """The port's ProfileDB over the same arrays as a JAX ProfileDB."""
    return TorchDB(db.names, db.lengths, db.taxids, db.pssm, db.offsets, ka_lambda=db.ka_lambda, ka_k=db.ka_k)


def _both(names, seqs, db, **kwargs):
    """(JAX result, port result) of one search."""
    ref = jps.search(names, seqs, db, **kwargs)
    got = tps.search(names, seqs, _twin(db), device="cpu", **kwargs)
    return ref, got


def _seq(res):
    return "".join(ALPHABET[r] for r in res)


def _mutated(rng, cons, frac):
    seq = cons.copy()
    pos = rng.choice(len(seq), max(1, int(len(seq) * frac)), replace=False)
    seq[pos] = rng.integers(0, N_AA, len(pos))
    return seq


@pytest.mark.parametrize(
    "evalue_thr,min_cov,max_rejected",
    [
        (1e-3, 0.2, 280),  # production defaults
        (1e-3, 0.8, 280),  # strict profile coverage: fragments drop
        (1e-12, 0.2, 1),  # harsh gate + stop at the first rejection
        (1e-12, 0.2, 2),
        (1e-3, 0.2, 0),  # stop rule disabled
    ],
)
def test_search_equals_jax_orientation_cases(evalue_thr, min_cov, max_rejected):
    db, names, seqs, _ = _make_db_and_queries()
    ref, got = _both(names, seqs, db, evalue_threshold=evalue_thr, min_cov=min_cov, max_rejected=max_rejected)
    assert got == ref


@pytest.mark.parametrize("max_rejected", [0, 1, 2])
def test_search_stop_rule_drops_later_accept_as_jax(max_rejected):
    """The case of test_search_max_rejected_drops_later_accept: a fragment
    with a high prefilter score walks first and is rejected; at
    max_rejected 1 its rejection stops the profile's list before the
    full-length homolog."""
    db = ProfileDB.synthetic(seed=41, n_profiles=300, min_len=100, max_len=140, integral=True)
    target = 57
    cons = db.consensus(target)
    rng = np.random.default_rng(2)
    mut = cons.copy()
    pos = np.arange(0, len(mut), 3)
    mut[pos] = (mut[pos] + 1 + rng.integers(0, N_AA - 1, len(pos))) % N_AA
    names, seqs = ["g_frag", "g_mut"], [_seq(cons[:40]), _seq(mut)]
    loose = jps.search(names, seqs, db, evalue_threshold=1e3)
    lam, kk, n_set = jps.KA_LAMBDA, jps.KA_K, sum(len(s) for s in seqs)
    evs = {}
    for n in names:
        raw = (loose[n][2] * jps.LN2 + np.log(kk)) / lam
        evs[n] = kk * int(db.lengths[target]) * n_set * np.exp(-lam * raw)
    thr = float(np.sqrt(evs["g_mut"] * evs["g_frag"]))
    ref, got = _both(names, seqs, db, evalue_threshold=thr, max_rejected=max_rejected)
    assert got == ref
    assert ("g_mut" in ref) == (max_rejected != 1)  # the stop rule fired at 1
    both_ref, both_got = _both(names, seqs, db, evalue_threshold=float(evs["g_frag"] * 4), max_rejected=max_rejected)
    assert both_got == both_ref and len(both_ref) == 2


@pytest.mark.parametrize("min_cov", [0.2, 0.8])
def test_search_profile_coverage_as_jax(min_cov):
    db = ProfileDB.synthetic(seed=3, n_profiles=300, min_len=40, max_len=50, integral=True)
    cons = db.consensus(123).astype(np.int8)
    ref, got = _both(["g_1"], [_seq(cons[: len(cons) // 2])], db, min_cov=min_cov)
    assert got == ref
    assert bool(ref) == (min_cov == 0.2)


def test_search_gate_search_space_as_jax():
    """The gate's n is the protein set's residue count: an unrelated query
    added to the set flips a hit at the edge threshold, in both engines."""
    db = ProfileDB.synthetic(seed=9, n_profiles=300, min_len=40, max_len=60, integral=True)
    target = 42
    rng = np.random.default_rng(1)
    seq = _mutated(rng, db.consensus(target).astype(np.int8), 0.25)
    qseq = _seq(seq)
    solo_ref, solo_got = _both(["g_1"], [qseq], db, evalue_threshold=1e30)
    assert solo_got == solo_ref and solo_ref
    raw = (solo_ref["g_1"][2] * jps.LN2 + math.log(jps.KA_K)) / jps.KA_LAMBDA
    thr = jps.KA_K * int(db.lengths[target]) * len(seq) * math.exp(-jps.KA_LAMBDA * raw) * 8
    at_ref, at_got = _both(["g_1"], [qseq], db, evalue_threshold=thr)
    assert at_got == at_ref and at_ref
    noise = _seq(rng.integers(0, N_AA, len(seq) * 100))
    both_ref, both_got = _both(["g_1", "g_2"], [qseq, noise], db, evalue_threshold=thr)
    assert both_got == both_ref and "g_1" not in both_ref


def _pm_case():
    db = ProfileDB.synthetic(seed=91, n_profiles=400, min_len=60, max_len=150, integral=True)
    rng = np.random.default_rng(6)
    names, seqs = [], []
    for qi in range(80):
        if qi % 3 < 2:
            seq = _mutated(rng, db.consensus(int(rng.integers(0, 400))), 1 / 8)
        else:
            seq = rng.integers(0, N_AA, int(rng.integers(60, 150)))
        names.append(f"g_{qi}")
        seqs.append(_seq(seq))
    return db, names, seqs


@pytest.mark.parametrize("profile_major", [False, True])
@pytest.mark.parametrize(
    "kwargs",
    [{}, {"max_rejected": 1, "evalue_threshold": 1e-12}, {"max_rejected": 0}, {"max_rejected": 2, "evalue_threshold": 1e-25}],
    ids=["defaults", "stop1", "nostop", "stop2"],
)
def test_search_modes_equal_jax(monkeypatch, profile_major, kwargs):
    """Streaming and profile-major modes, with tiny profile-major rounds
    so rejection runs carry across rounds (as test_profile_major_mode_
    matches_streaming); 80 queries make two prefilter groups, so the
    streaming mode overlaps the prefilter with the alignment."""
    monkeypatch.setattr(jps, "_PM_ROUND", 4)
    monkeypatch.setattr(tps, "_PM_ROUND", 4)
    db, names, seqs = _pm_case()
    ref = jps.search(names, seqs, db, profile_major=False, **kwargs)
    got = tps.search(names, seqs, _twin(db), device="cpu", profile_major=profile_major, **kwargs)
    assert got == ref and len(ref) > 10


def test_search_auto_selects_profile_major(monkeypatch):
    """GENOMAD_PROFILE_MAJOR_MIN switches the port to profile-major as it
    switches the JAX engine."""
    monkeypatch.setenv("GENOMAD_PROFILE_MAJOR_MIN", "10")
    calls = []
    real = tps._run_profile_major
    monkeypatch.setattr(tps, "_run_profile_major", lambda *a, **k: calls.append(1) or real(*a, **k))
    db, names, seqs = _pm_case()
    assert tps.search(names, seqs, _twin(db), device="cpu") == jps.search(names, seqs, db)
    assert calls == [1]


@pytest.mark.parametrize("skip_prefilter", [False, True])
def test_search_all_pairs_path_equals_jax(skip_prefilter):
    """DBs of 256 profiles or fewer (and skip_prefilter) align every pair
    with the stop rule off."""
    n_profiles = 300 if skip_prefilter else 120
    db = ProfileDB.synthetic(seed=11, n_profiles=n_profiles, min_len=60, max_len=200)
    rng = np.random.default_rng(42)
    names, seqs = [], []
    for qi, target in enumerate([3, 50, 99, 117]):
        names.append(f"contig1_{qi + 1}")
        seqs.append(_seq(_mutated(rng, db.consensus(target), 0.1)))
    names.append("noise")
    seqs.append(_seq(rng.integers(0, N_AA, 100)))
    ref, got = _both(names, seqs, db, skip_prefilter=skip_prefilter, max_rejected=1)
    assert got == ref and len(ref) == 4


def test_search_long_buckets_equal_jax():
    """Profiles and queries in the 768 and 1024 length classes."""
    rng = np.random.default_rng(31)
    names, pssms = [], []
    for i, L in enumerate([80, 300, 600, 700, 900] * 3):
        cons = rng.integers(0, N_AA, L)
        pssm = np.full((L, N_AA), -2.0, np.float32)
        pssm[np.arange(L), cons] = 6.0
        names.append(f"p{i}")
        pssms.append(pssm)
    db = ProfileDB.from_profiles(names, pssms)
    qnames, qseqs = [], []
    for qi, t in enumerate([2, 3, 4]):
        qnames.append(f"g_{qi}")
        qseqs.append(_seq(_mutated(rng, db.profile(t).argmax(1), 0.1)))
    ref, got = _both(qnames, qseqs, db)
    assert got == ref
    assert [got[f"g_{qi}"][0] for qi in range(3)] == ["p2", "p3", "p4"]


def test_search_length_over_limit_raises_as_jax():
    db = ProfileDB.synthetic(seed=5, n_profiles=8, min_len=40, max_len=60)
    seq = _seq(np.random.default_rng(0).integers(0, N_AA, 32_769))
    for engine, target in ((jps.search, db), (tps.search, _twin(db))):
        kwargs = {"device": "cpu"} if engine is tps.search else {}
        with pytest.raises(ValueError, match="exceeds the maximum supported operand length 32768"):
            engine(["long"], [seq], target, **kwargs)


def test_search_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    db = TorchDB.synthetic(seed=5, n_profiles=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tps.search(["q"], ["ACDEFGHIK"], db)


def test_search_counts_its_stages_and_the_native_prefilter():
    from genomad_torch import native

    db, names, seqs = _pm_case()
    tps.STATS.clear()
    uses = native.native_prefilter_batch.uses
    tps.search(names, seqs, _twin(db), device="cpu")
    assert {"prefilter_s", "staging_s", "sw_forward_s", "sw_reverse_s", "finalize_s"} <= set(tps.STATS)
    assert tps.STATS["pairs_forward"] >= tps.STATS["pairs_reverse"] > 0
    assert tps.STATS["cells_forward"] > tps.STATS["cells_reverse"] > 0
    if native.get_library() is not None:  # g++ present: the C++ prefilter served the search
        assert native.native_prefilter_batch.uses > uses
        assert native._LIB_PATH.parent.name == "build"
