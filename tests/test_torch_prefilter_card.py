"""The marker search's prefilter on the card (``ops.prefilter``,
csrc/prefilter.cu) against its plain version, the C++ prefilter
(``native.native_prefilter_batch``): the same ids, the same f32 scores bit
for bit, the same drop count and the same work counts, on synthetic DBs in
every mode, on hand-built hit orders where the last-diagonal rule decides,
and through the whole search. Marked ``chip``: they skip without a card.
On the card (no JAX there, so without the repository's conftest):

    python -m pytest --noconftest tests/test_torch_prefilter_card.py -m chip -q

The CPU route's engagement counters are tested in
tests/test_torch_protein_search.py."""

import numpy as np
import pytest
import torch

from genomad_torch import native, trace
from genomad_torch.ops import blosum, profiledb
from genomad_torch.ops import protein_search as ps
from genomad_torch.ops.prefilter import card_prefilter_batch
from genomad_torch.ops.profiledb import N_AA, ProfileDB

WORK = ("prefilter.queries", "prefilter.hits", "prefilter.codes", "prefilter.candidates")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _counted(fn, *args, **kwargs):
    before = dict(trace.COUNTERS)
    out = fn(*args, **kwargs)
    return out, {k: trace.COUNTERS[k] - before.get(k, 0.0) for k in WORK}


def _both(db, residues_list, min_score=25.0, max_out=None, s=4.2, bias=True):
    """Runs both routes on the same inputs, asserts that they agree and
    returns the C++'s result and work counts."""
    dev = _card()
    kw = dict(
        max_out_per_query=db.n_profiles if max_out is None else max_out,
        kmer_thr=None if s is None else blosum.kmer_score_threshold(s),
        bias_list=[blosum.comp_bias(r) for r in residues_list] if bias else None,
    )
    index = db.kmer_index(1)
    ref, ref_work = _counted(native.native_prefilter_batch, index, residues_list, db, min_score, **kw)
    launches = card_prefilter_batch.launches
    got, got_work = _counted(card_prefilter_batch, index, residues_list, db, min_score, device=dev, **kw)
    assert card_prefilter_batch.launches == launches + (1 if residues_list else 0)
    assert got[2] == ref[2], "dropped"
    assert len(got[0]) == len(ref[0]) == len(residues_list)
    for q, (gi, ri, gs, rs) in enumerate(zip(got[0], ref[0], got[1], ref[1])):
        assert np.array_equal(gi, ri), f"query {q}: ids"
        assert gs.dtype == np.float32 and np.array_equal(gs.view(np.int32), rs.view(np.int32)), f"query {q}: scores"
    assert got_work == ref_work
    return ref, ref_work


def _queries(db, n, seed, mutate=0.15, unknown=0.0, short=0):
    """Mutated consensus sequences of random profiles (planted hits), random
    proteins, and ``short`` queries of 1-4 residues; ``unknown`` is the share
    of positions set to code 20 (X)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 3 == 2:
            seq = rng.integers(0, N_AA, int(rng.integers(30, 300))).astype(np.int8)
        else:
            seq = db.consensus(int(rng.integers(0, db.n_profiles))).copy()
            pos = rng.choice(len(seq), int(len(seq) * mutate), replace=False)
            seq[pos] = rng.integers(0, N_AA, len(pos))
        if unknown:
            seq[rng.random(len(seq)) < unknown] = 20
        out.append(seq.astype(np.int8))
    out += [rng.integers(0, N_AA, k).astype(np.int8) for k in range(1, short + 1)]
    return out


@pytest.fixture(scope="module")
def int_db():
    return ProfileDB.synthetic(seed=11, n_profiles=1500, min_len=40, max_len=400, integral=True)


@pytest.fixture(scope="module")
def f32_db():
    db = ProfileDB.synthetic(seed=12, n_profiles=1200, min_len=40, max_len=300)
    assert db.pssm_i8 is None
    return db


@pytest.mark.chip
@pytest.mark.parametrize("s", [None, 1.0, 4.2, 7.5])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("pssm", ["int8", "f32"])
def test_card_prefilter_equals_the_cpp(s, bias, pssm, int_db, f32_db):
    db = int_db if pssm == "int8" else f32_db
    assert (db.pssm_i8 is not None) == (pssm == "int8")
    ref, work = _both(db, _queries(db, 40, seed=7), s=s, bias=bias)
    assert work["prefilter.candidates"] > 0 and sum(len(i) for i in ref[0]) > 0


@pytest.mark.chip
def test_unknown_residues_and_short_queries(int_db):
    residues = _queries(int_db, 30, seed=8, unknown=0.05, short=4)
    assert any((r == 20).any() for r in residues) and min(len(r) for r in residues) == 1
    for s in (None, 4.2):
        ref, _ = _both(int_db, residues, s=s)
        assert all(len(ids) == 0 for ids in ref[0][-4:])  # no 5-mer, no candidate


@pytest.mark.chip
def test_no_queries_launches_nothing(int_db):
    dev = _card()
    launches = card_prefilter_batch.launches
    assert card_prefilter_batch(int_db.kmer_index(1), [], int_db, 25.0, device=dev) == ([], [], 0)
    assert card_prefilter_batch.launches == launches


@pytest.mark.chip
def test_a_small_cap_drops_the_same_candidates(int_db):
    ref, _ = _both(int_db, _queries(int_db, 24, seed=9), max_out=3, s=7.5)
    assert ref[2] > 0 and max(len(i) for i in ref[0]) == 3


def _pattern_db():
    """One 60-column profile (consensus +9, every other residue -3) whose
    consensus was drawn so that, at -s 1.0, the queries below hit it only
    where they copy it."""
    c = np.random.default_rng(44).integers(0, N_AA, 60).astype(np.int8)
    pssm = np.full((60, N_AA), -3.0, np.float32)
    pssm[np.arange(60), c] = 9.0
    return ProfileDB.from_profiles(["GENOMAD.000000.XX"], [pssm]), c


@pytest.mark.chip
def test_hit_orders_where_the_last_diagonal_rule_decides():
    db, c = _pattern_db()
    # diagonals A (10), B (35), A: two hits on A, but B lies between them,
    # so the stamp holds B when A comes back and no double hit is seen
    aba = np.concatenate([c[10:15], c[40:45], c[20:25]])
    # A A, B B, A A: a double hit on A, one on B, and one on A again, which
    # pushes A a second time (the last double hit was on B)
    aabbaa = np.concatenate([c[10:16], c[40:46], c[22:28]])
    ref, work = _both(db, [aba], s=1.0, bias=False)
    assert work["prefilter.hits"] == 3 and work["prefilter.candidates"] == 0 and len(ref[0][0]) == 0
    ref, work = _both(db, [aabbaa], s=1.0, bias=False)
    assert work["prefilter.hits"] == 6 and work["prefilter.candidates"] == 3 and list(ref[0][0]) == [0]
    # exact k-mers: every hit off the previous diagonal pushes
    _, work = _both(db, [aba], s=None, bias=False)
    assert work["prefilter.candidates"] == 3


@pytest.mark.chip
def test_two_runs_agree_bitwise(int_db):
    dev = _card()
    residues = _queries(int_db, 40, seed=10)
    kw = dict(kmer_thr=blosum.kmer_score_threshold(4.2), bias_list=[blosum.comp_bias(r) for r in residues],
              max_out_per_query=int_db.n_profiles, device=dev)
    a = card_prefilter_batch(int_db.kmer_index(1), residues, int_db, 25.0, **kw)
    b = card_prefilter_batch(int_db.kmer_index(1), residues, int_db, 25.0, **kw)
    assert a[2] == b[2]
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert np.array_equal(x.view(np.int32), y.view(np.int32))


@pytest.mark.chip
def test_one_group_of_a_20000_profile_db():
    db = ProfileDB.synthetic(seed=3, n_profiles=20_000, min_len=60, max_len=400, integral=True)
    ref, work = _both(db, _queries(db, 128, seed=4))
    assert work["prefilter.queries"] == 128 and work["prefilter.hits"] > 1e6


def _search_case():
    db = ProfileDB.synthetic(seed=21, n_profiles=600, min_len=40, max_len=200, integral=True)
    residues = _queries(db, 150, seed=22)
    alphabet = np.array(list(profiledb.ALPHABET + "X"))
    return db, [f"q{i}" for i in range(len(residues))], ["".join(alphabet[r]) for r in residues]


@pytest.mark.chip
@pytest.mark.parametrize("profile_major", [False, True])
def test_the_search_on_the_card_equals_the_search_on_the_cpu(profile_major):
    dev = _card()
    db, names, seqs = _search_case()
    cpu = ps.search(names, seqs, db, device="cpu", batch_size=64, profile_major=profile_major)
    ps.STATS.clear()
    launches, uses = card_prefilter_batch.launches, native.native_prefilter_batch.uses
    card = ps.search(names, seqs, db, device=dev, batch_size=64, profile_major=profile_major)
    assert card == cpu and len(card) > 10
    groups = ps.STATS["search.groups"]
    assert groups == 3 and ps.STATS["prefilter.card_groups"] == groups and "prefilter.host_groups" not in ps.STATS
    assert card_prefilter_batch.launches == launches + groups and native.native_prefilter_batch.uses == uses
    assert "prefilter.thread_s" not in ps.STATS
