"""The port's search engine (``genomad_torch.ops.protein_search.search`` on
the CPU, K1 through its plain version) returns the same hit table as the
JAX engine's ``search`` on synthetic profile DBs: the stop rule firing, the
profile-coverage gate, the gate's search space, both scheduling modes, the
all-pairs path, the 768/1024 length buckets, a tail of profiles longer
than 1,024 columns and the length limit."""

import math
from pathlib import Path

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


def _fragment_case():
    """The case of test_search_max_rejected_drops_later_accept: a fragment
    with a high prefilter score and a full-length homolog of one profile,
    their gate E-values as JAX reports them."""
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
    return db, names, seqs, evs


@pytest.mark.parametrize("max_rejected", [0, 1, 2])
def test_search_stop_rule_drops_later_accept_as_jax(max_rejected):
    """The fragment walks first and is rejected; at max_rejected 1 its
    rejection stops the profile's list before the full-length homolog."""
    db, names, seqs, evs = _fragment_case()
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


@pytest.mark.parametrize("n", [0, 1, 100_000])
@pytest.mark.parametrize("max_rejected", [1, 3, 280])
def test_stop_rule_equals_the_jax_mask_after_its_lexsort(n, max_rejected):
    """The port's stop rule (torch ops, here on CPU tensors) against the
    JAX engine's NumPy mask over ``np.lexsort((genes, -pf, profs))``: the
    same walk order, aligned pairs, carries out and stopped profiles. The
    scores take a handful of values, -0.0 and +0.0 among them, so most
    pairs tie; carries in are non-zero; a quarter of the profiles keep
    nothing, so a walk of ~330 pairs reaches 280 rejections by itself, and
    a quarter keep everything and never stop."""
    rng = np.random.default_rng([n, max_rejected])
    n_profiles = 300
    genes = np.sort(rng.integers(0, 2_000, n)).astype(np.int32)  # as appended: genes ascending
    profs = rng.integers(0, n_profiles, n).astype(np.int32)
    pf = rng.choice(np.array([-3.5, -0.0, 0.0, 25.0, 31.5, 40.0], np.float32), n)
    keep = rng.random(n) < np.array([0.0, 0.02, 0.4, 1.0], np.float32)[profs % 4]
    carry = rng.integers(0, max_rejected, n_profiles).astype(np.int64)

    order = np.lexsort((genes, -pf, profs))
    walk = tps._walk_order(torch.from_numpy(profs), torch.from_numpy(pf))
    np.testing.assert_array_equal(walk.numpy(), order)
    aligned, new_carry, stopped = tps._stop_rule(
        torch.from_numpy(profs), torch.from_numpy(pf), torch.from_numpy(keep), torch.from_numpy(carry.copy()), max_rejected
    )
    if n == 0:  # the JAX mask takes no empty table
        ref_aligned, ref_carry, ref_stopped = np.zeros(0, bool), carry, np.zeros(0, bool)
    else:
        aligned_o, ref_carry, ref_stopped = jps._max_rejected_mask(profs[order], keep[order], carry.copy(), max_rejected)
        ref_aligned = np.empty(n, bool)
        ref_aligned[order] = aligned_o
    uniq = np.unique(profs)  # the JAX mask's segments, in order
    np.testing.assert_array_equal(aligned.numpy(), ref_aligned)
    np.testing.assert_array_equal(new_carry.numpy(), ref_carry)
    np.testing.assert_array_equal(stopped.numpy()[uniq], ref_stopped)
    assert not stopped.numpy()[np.setdiff1d(np.arange(n_profiles), uniq)].any()
    if n > 1:  # the rule fired, and not on every profile
        assert 0 < ref_stopped.sum() < len(uniq)


@pytest.mark.parametrize("case", ["two_groups", "fragment"])
def test_streaming_records_stay_on_the_aligners_device(monkeypatch, case):
    """The streaming search hands the stop rule one table of forward
    records, tensors where the aligner left its stats (here the CPU), the
    genes non-decreasing as the walk order's ties need (two prefilter
    groups in the stop1 case of test_search_modes_equal_jax). Every forward
    pair is finalized on the host, none on the card, and the hits equal
    JAX's; in the fragment case the rule fires at max_rejected 1."""
    if case == "two_groups":
        db, names, seqs = _pm_case()
        kwargs = {"max_rejected": 1, "evalue_threshold": 1e-12}
    else:
        db, names, seqs, evs = _fragment_case()
        kwargs = {"max_rejected": 1, "evalue_threshold": float(np.sqrt(evs["g_mut"] * evs["g_frag"]))}
    seen = []
    real = tps._survivors
    monkeypatch.setattr(tps, "_survivors", lambda *a, **k: seen.append(a) or real(*a, **k))
    keys = ("pairs_forward", "pairs_reverse", "finalize.pairs_on_host", "finalize.pairs_on_card")
    before = {k: tps.STATS[k] for k in keys}
    got = tps.search(names, seqs, _twin(db), device="cpu", profile_major=False, **kwargs)
    moved = {k: tps.STATS[k] - before[k] for k in keys}
    assert got == jps.search(names, seqs, db, **kwargs)
    assert len(got) > 10 if case == "two_groups" else "g_mut" not in got
    ((genes, profs, pf, stats),) = seen
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in (genes, profs, pf, stats))
    assert bool((genes[1:] >= genes[:-1]).all()) and bool((genes[1:] > genes[:-1]).any())
    assert moved["finalize.pairs_on_host"] == moved["pairs_forward"] == len(genes) and moved["finalize.pairs_on_card"] == 0
    passed = int((stats[:, 3] <= np.float32(kwargs["evalue_threshold"])).sum())
    # the stop rule drops pairs that passed the gate only where it fires
    assert moved["pairs_reverse"] <= passed and (moved["pairs_reverse"] < passed) == (case == "fragment")


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


def test_search_long_profile_tail_equals_jax():
    """A DB with a tail of 1,025-1,500-column profiles (the 4096 bucket,
    K1's long body on the card): windows of a long profile's consensus that
    end past column 1,024, mutated short consensus sequences and noise. The
    queries and the short profiles all lie in the 384 bucket, which keeps
    JAX's compiles to two bucket pairs."""
    rng = np.random.default_rng(37)
    short = ProfileDB.synthetic(seed=12, n_profiles=40, min_len=260, max_len=380, integral=True)
    long = ProfileDB.synthetic(seed=13, n_profiles=6, min_len=1025, max_len=1500, integral=True)
    pssms = [short.profile(i) for i in range(40)] + [long.profile(i) for i in range(6)]
    db = ProfileDB.from_profiles([f"p{i}" for i in range(len(pssms))], pssms)
    names, seqs, want = [], [], {}
    for k in range(6):
        n = int(rng.integers(300, 380))
        start = int(rng.integers(1024 - n + 60, int(db.lengths[40 + k]) - n + 1))
        names.append(f"window_{k}")
        seqs.append(_seq(_mutated(rng, db.profile(40 + k).argmax(1)[start : start + n], 0.1)))
        want[names[-1]] = f"p{40 + k}"
    for k in (3, 17, 29):
        names.append(f"short_{k}")
        seqs.append(_seq(_mutated(rng, db.profile(k).argmax(1), 0.1)))
        want[names[-1]] = f"p{k}"
    names.append("noise")
    seqs.append(_seq(rng.integers(0, N_AA, 350)))
    ref, got = _both(names, seqs, db)
    assert got == ref
    assert {q: got[q][0] for q in want} == want


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
    assert native.native_prefilter_batch.uses > uses
    assert Path(native.library()._name).parent.name == "build"


def test_a_cpu_search_prefilters_on_the_host():
    from genomad_torch.ops.prefilter import card_prefilter_batch

    db, names, seqs = _pm_case()
    tps.STATS.clear()
    launches = card_prefilter_batch.launches
    tps.search(names, seqs, _twin(db), device="cpu", batch_size=64)
    assert tps.STATS["search.groups"] == 2
    assert tps.STATS["prefilter.host_groups"] == tps.STATS["search.groups"]
    assert tps.STATS.get("prefilter.card_groups", 0) == 0
    assert card_prefilter_batch.launches == launches


# ---------------------------------------------------------------------------
# The cold-start prestage (DBs above 4,096 profiles, one process)
# ---------------------------------------------------------------------------


def _prestage_case(max_len=60):
    """The fixture of JAX's test_prestage_thread_path_large_db: 4,200
    integral profiles and three planted queries (``max_len`` 300 spreads
    the profiles over three length classes)."""
    db = ProfileDB.synthetic(seed=55, n_profiles=4200, min_len=30, max_len=max_len, integral=True)
    rng = np.random.default_rng(4)
    names, seqs, targets = [], [], (7, 1033, 4100)
    for qi, t in enumerate(targets):
        names.append(f"g_{qi}")
        seqs.append(_seq(_mutated(rng, db.consensus(t), 0.1)))
    return db, names, seqs, targets


def _count_builds(monkeypatch, delay: float = 0.0):
    """Records the thread name and key of every bucket build; builds on the
    prestage thread take ``delay`` seconds longer."""
    import threading
    import time

    builds = []
    real = tps._build_staged_bucket

    def build(db, pb_i, device, shard=(0, 1)):
        name = threading.current_thread().name
        builds.append((name, (str(device), int(pb_i), tuple(shard))))
        if name == tps.PRESTAGE_THREAD:
            time.sleep(delay)
        return real(db, pb_i, device, shard)

    monkeypatch.setattr(tps, "_build_staged_bucket", build)
    return builds


@pytest.mark.parametrize("max_len", [60, 300])
@pytest.mark.parametrize("profile_major", [False, True])
def test_prestage_search_equals_jax_and_builds_each_bucket_once(monkeypatch, max_len, profile_major):
    """The search starts the prestage thread in both modes; its hits equal
    JAX's search (which prestages too), and every bucket class of the DB
    is cached once and built once, whichever thread built it."""
    db, names, seqs, targets = _prestage_case(max_len)
    starts = []
    real = tps._prestage
    monkeypatch.setattr(tps, "_prestage", lambda *a: starts.append(a[1]) or real(*a))
    builds = _count_builds(monkeypatch)
    twin = _twin(db)
    got = tps.search(names, seqs, twin, device="cpu", profile_major=profile_major)
    assert tps.join_prestage(timeout=30)
    assert got == jps.search(names, seqs, db)
    assert [got[n][0] for n in names] == [str(db.names[t]) for t in targets]
    assert starts == [[(torch.device("cpu"), (0, 1))]]
    classes = np.unique(tps._bucket_bound(db.lengths))
    assert len(classes) == (1 if max_len == 60 else 3)
    want = sorted(("cpu", int(c), (0, 1)) for c in classes)
    assert sorted(twin.__dict__["_torch_device_buckets"]) == want
    assert sorted(key for _, key in builds) == want


def test_prestage_on_a_mesh_stages_each_cells_shard(monkeypatch):
    """On a (2, 2) mesh of ``cpu`` cells the prestage stages every bucket
    class's two db shards (the keys the cells' aligners read), each once;
    the hits equal JAX's unsharded search."""
    from genomad_torch.parallel import mesh as tmesh

    db, names, seqs, _ = _prestage_case(300)
    builds = _count_builds(monkeypatch)
    twin = _twin(db)
    got = tps.search(names, seqs, twin, mesh=tmesh.make_mesh(2, 2, devices=["cpu"] * 4))
    assert tps.join_prestage(timeout=30)
    assert got == jps.search(names, seqs, db)
    want = sorted(("cpu", int(c), (d, 2)) for c in np.unique(tps._bucket_bound(db.lengths)) for d in range(2))
    assert sorted(twin.__dict__["_torch_device_buckets"]) == want
    assert sorted(key for _, key in builds) == want


def test_prestage_stops_after_a_search_that_raises(monkeypatch):
    """A search whose prefilter raises stops its prestage thread after the
    bucket in flight: the thread ends within seconds, with classes left
    unstaged."""
    from genomad_torch import native

    db, names, seqs, _ = _prestage_case(300)
    builds = _count_builds(monkeypatch, delay=0.5)

    def broken(*args, **kwargs):
        raise RuntimeError("prefilter failed")

    monkeypatch.setattr(native, "native_prefilter_batch", broken)
    twin = _twin(db)
    with pytest.raises(RuntimeError, match="prefilter failed"):
        tps.search(names, seqs, twin, device="cpu")
    assert tps.join_prestage(timeout=5)
    n_classes = len(np.unique(tps._bucket_bound(db.lengths)))
    assert n_classes == 3 and len(builds) < n_classes
    assert all(name == tps.PRESTAGE_THREAD for name, _ in builds)


def test_no_prestage_at_4096_profiles_or_all_pairs(monkeypatch):
    """The JAX condition: more than 4,096 profiles and the prefilter on.
    At 4,096 profiles, and with skip_prefilter, no thread starts and the
    calling thread stages what it aligns."""
    import threading

    starts = []
    monkeypatch.setattr(tps, "_prestage", lambda *a: starts.append(a))
    builds = _count_builds(monkeypatch)
    db, names, seqs, _ = _prestage_case()
    at_limit = ProfileDB.synthetic(seed=55, n_profiles=4096, min_len=30, max_len=60, integral=True)
    ref, got = _both(names, seqs, at_limit)
    assert got == ref and got
    _, got = _both(names[:1], seqs[:1], db, skip_prefilter=True)
    assert got
    assert starts == []
    assert builds and all(name == threading.current_thread().name for name, _ in builds)


def test_search_sharded_small_shards_equal_jax():
    """300 profiles in 2 shards: each shard of 150 falls under the
    all-pairs threshold (256), so each shard search aligns every pair with
    the stop rule off. The port's search_sharded equals JAX's. Recorded
    (JAX behaviour, matched, not fixed): neither equals the unsharded
    search, which prefilters. On these 70%-substituted homologs the shards
    find every unsharded hit and two weak ones the prefilter drops."""
    db = ProfileDB.synthetic(seed=77, n_profiles=300, min_len=60, max_len=150, integral=True)
    rng = np.random.default_rng(12)
    names, seqs = [], []
    for qi in range(24):
        cons = db.consensus(int(rng.integers(0, 300))).copy()
        pos = rng.choice(len(cons), int(len(cons) * 0.7), replace=False)
        cons[pos] = rng.integers(0, N_AA, len(pos))
        names.append(f"g_{qi}")
        seqs.append(_seq(cons))
    ref = jps.search_sharded(names, seqs, db, 2)
    got = tps.search_sharded(names, seqs, _twin(db), 2, device="cpu")
    assert got == ref and ref
    unsharded = jps.search(names, seqs, db)
    assert tps.search(names, seqs, _twin(db), device="cpu") == unsharded
    assert {n: ref[n] for n in unsharded} == unsharded
    assert sorted(set(ref) - set(unsharded)) == ["g_13", "g_5"]


def test_staging_and_stats_hold_under_racing_threads(monkeypatch):
    """16 threads at a short switch interval stage the same buckets and
    count into STATS at once: each bucket is built once, every thread gets
    the cached bucket, and no count is lost."""
    import sys
    import threading

    db = _twin(ProfileDB.synthetic(seed=3, n_profiles=600, min_len=30, max_len=300, integral=True))
    classes = [int(c) for c in np.unique(tps._bucket_bound(db.lengths))]
    builds = _count_builds(monkeypatch)
    tps.STATS.clear()
    got = []

    def work():
        for c in classes:
            got.append((c, tps._get_staged_profiles(db, c, torch.device("cpu"))))
        for _ in range(2000):
            tps._count("race", 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(key for _, key in builds) == [("cpu", c, (0, 1)) for c in classes]
    cache = db.__dict__["_torch_device_buckets"]
    assert len(got) == 16 * len(classes) and all(b is cache[("cpu", c, (0, 1))] for c, b in got)
    assert tps.STATS["race"] == 16 * 2000
