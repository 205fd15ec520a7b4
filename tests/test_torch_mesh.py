"""The port's mesh (``genomad_torch.parallel``) on the CPU, every cell
``cpu``: the ports of tests/test_sharded_search.py and
tests/test_multihost.py. The mesh search gives the unsharded search's hits
(the port's, bit for bit, and the JAX engine's) at every mesh shape, the
threshold-edge gate, the compareHits tie-break of the host shard loop,
profile-major over the mesh, the dense best hits, a two-process gloo
search, and predict_windows over the data axis."""

import json

import numpy as np
import pytest
import torch

from genomad_torch.models import igloo as tig
from genomad_torch.modules import annotate as tannotate
from genomad_torch.ops import nn_pipeline as tpipe
from genomad_torch.ops import protein_search as tps
from genomad_torch.ops.profiledb import ProfileDB as TorchDB
from genomad_torch.parallel import mesh as tmesh
from genomad_torch.parallel import sharded_search as tsharded
from genomad_tpu.ops import protein_search as jps
from genomad_tpu.ops.profiledb import ALPHABET, N_AA, ProfileDB
from genomad_tpu.parallel import mesh as jmesh
from genomad_tpu.parallel import sharded_search as jsharded
from tests.test_sharded_search import _make_queries, assert_hits_equivalent, make_dense
from tests.test_torch_igloo import random_base_codes, tiny_params
from tests.test_torch_protein_search import _twin
from tests.test_torch_train import spawn_ranks

torch.set_num_threads(2)

MESH_SHAPES = [(1, 2), (2, 2), (2, 4), (8, 1)]


def cpu_mesh(n_data, n_db):
    return tmesh.make_mesh(n_data, n_db, devices=["cpu"] * (n_data * n_db))


@pytest.mark.parametrize("n", range(1, 17))
def test_balanced_factorization_equals_jax(n):
    assert tmesh.balanced_factorization(n) == jmesh.balanced_factorization(n)


def test_mesh_cells_shape_and_errors():
    mesh = cpu_mesh(2, 4)
    assert mesh.shape == {"data": 2, "db": 4} and mesh.size == 8
    assert mesh.rank_cells == [(g, d) for g in range(2) for d in range(4)]
    assert all(dev == torch.device("cpu") for dev in mesh.devices.flat)
    assert mesh.gather(np.ones(3)) is not None
    assert tmesh.make_mesh(n_db=2, devices=["cpu"] * 5).shape == {"data": 2, "db": 2}
    with pytest.raises(ValueError, match="needs 6 devices"):
        tmesh.make_mesh(3, 2, devices=["cpu"] * 4)
    assert tmesh.pad_to_multiple(10, 4) == jmesh.pad_to_multiple(10, 4) == 12
    assert not tmesh.initialize_distributed()  # the environment names no group


def test_default_meshes_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh()
    assert tannotate.default_search_mesh() is None


@pytest.mark.parametrize("device", [None, "cuda:1"])
def test_run_search_builds_no_mesh_without_a_group(device, tmp_path, monkeypatch):
    """Four visible cards and no process group: ``run_search`` builds no
    mesh, and an explicit device reaches ``search`` as it was given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    calls = []
    monkeypatch.setattr(tps, "search", lambda *a, **kw: calls.append(kw) or {})

    class _DB:
        def get_profile_db(self, **_):
            return None

    proteins = tmp_path / "p.faa"
    proteins.write_text(">g1\nMKV\n")
    tannotate.run_search(proteins, tmp_path / "hits.tsv", _DB(), device=device)
    assert tannotate.default_search_mesh() is None
    assert [(kw["device"], kw["mesh"]) for kw in calls] == [(device, None)]


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_search_on_mesh_equals_unsharded(shape):
    """tests/test_sharded_search.py::test_production_search_sharded_matches_host
    at each mesh shape: the port's unsharded hits bit for bit, JAX's as
    assert_hits_equivalent holds them."""
    db = ProfileDB.synthetic(seed=7, n_profiles=300, min_len=40, max_len=180)
    names, seqs = _make_queries(db, 48, seed=3)
    ref = jps.search(names, seqs, db)
    tdb = _twin(db)
    plain = tps.search(names, seqs, tdb, device="cpu")
    got = tps.search(names, seqs, tdb, mesh=cpu_mesh(*shape))
    assert ref, "expected hits from planted queries"
    assert got == plain
    assert_hits_equivalent(got, ref)


def test_gate_threshold_edge_consistency():
    """E-value-marginal pairs pass or fail identically on the unsharded and
    the mesh paths, in the port and in JAX."""
    db = ProfileDB.synthetic(seed=23, n_profiles=64, min_len=60, max_len=120)
    names, seqs = _make_queries(db, 8, seed=9)
    tdb = _twin(db)
    base = tps.search(names, seqs, tdb, device="cpu", evalue_threshold=1e3)
    assert base, "expected hits at a permissive threshold"
    mesh = cpu_mesh(2, 4)
    evs = sorted(ev for (_, ev, _, _) in base.values())
    for ev in evs[:2]:
        for thr in (ev * (1 - 1e-6), ev, ev * (1 + 1e-6)):
            host = tps.search(names, seqs, tdb, device="cpu", evalue_threshold=thr)
            shard = tps.search(names, seqs, tdb, mesh=mesh, evalue_threshold=thr)
            assert shard == host, f"thr={thr!r}"
            assert host == jps.search(names, seqs, db, evalue_threshold=thr), f"thr={thr!r}"


def test_search_sharded_compare_hits_tiebreak():
    """The merge key of search_sharded is compareHits after the swap back:
    int bitscore desc, profile length asc, profile id asc (as
    tests/test_sharded_search.py::test_shard_merge_compare_hits_tiebreak)."""
    L = 40
    res = np.arange(L) % 20
    strong = np.full((L, N_AA), -5.0, np.float32)
    strong[np.arange(L), res] = 2.0  # raw 80.0, plen 40
    weak = np.full((L + 4, N_AA), -5.0, np.float32)
    weak[np.arange(L), res] = 2.0
    weak[0, res[0]] = 1.8  # raw 79.8: the same int bitscore, plen 44
    db = ProfileDB.from_profiles(["a_long_weak", "b_short_strong"], [weak, strong])
    names, seqs = ["q"], ["".join(ALPHABET[r] for r in res)]
    tdb = _twin(db)
    full = tps.search(names, seqs, tdb, device="cpu")
    assert full["q"][0] == "b_short_strong"
    assert full == jps.search(names, seqs, db)
    lone_weak = tps.search(names, seqs, tdb.shard(2, 0), device="cpu", db_positions=tdb.total_positions)
    assert full["q"][2] == lone_weak["q"][2]
    sharded = tps.search_sharded(names, seqs, tdb, n_shards=2, device="cpu")
    assert sharded == full == jps.search_sharded(names, seqs, db, n_shards=2)
    twin = ProfileDB.from_profiles(["p0", "p1"], [strong, strong.copy()])
    t_full = tps.search(names, seqs, _twin(twin), device="cpu")
    assert t_full["q"][0] == "p0"
    assert tps.search_sharded(names, seqs, _twin(twin), n_shards=2, device="cpu") == t_full


def test_host_loop_equals_mesh():
    db = ProfileDB.synthetic(seed=11, n_profiles=120, min_len=40, max_len=100)
    names, seqs = _make_queries(db, 24, seed=5)
    tdb = _twin(db)
    host_loop = tps.search_sharded(names, seqs, tdb, n_shards=4, device="cpu")
    on_mesh = tps.search(names, seqs, tdb, mesh=cpu_mesh(2, 4))
    assert_hits_equivalent(on_mesh, host_loop)
    assert_hits_equivalent(host_loop, jps.search_sharded(names, seqs, db, n_shards=4))


def test_profile_major_on_mesh_equals_streaming_and_host(monkeypatch):
    monkeypatch.setattr(tps, "_PM_ROUND", 8)
    db = ProfileDB.synthetic(seed=37, n_profiles=300, min_len=40, max_len=120)
    names, seqs = _make_queries(db, 24, seed=8)
    tdb = _twin(db)
    mesh = cpu_mesh(2, 4)
    stream = tps.search(names, seqs, tdb, mesh=mesh, profile_major=False)
    pmajor = tps.search(names, seqs, tdb, mesh=mesh, profile_major=True)
    assert stream == pmajor and pmajor
    host = tps.search(names, seqs, tdb, device="cpu", profile_major=True)
    assert pmajor == host
    assert_hits_equivalent(pmajor, jps.search(names, seqs, db, profile_major=True))


def _dense_case():
    db = ProfileDB.synthetic(seed=51, n_profiles=16, min_len=40, max_len=64)
    profiles = make_dense(db, 64)
    queries = np.full((8, 48), 20, np.int32)
    for qi, target in enumerate(range(0, 16, 2)):
        cons = db.consensus(target)[:48]
        queries[qi, : len(cons)] = cons
    # a tie: profile 15 is profile 1 again, so query 7's best of the two
    # must be the smaller index wherever the two land
    profiles[15] = profiles[1]
    queries[7] = np.full(48, 20, np.int32)
    queries[7, : min(48, int(db.lengths[1]))] = db.consensus(1)[:48]
    return queries, profiles


@pytest.mark.parametrize("shape", [None, (4, 2), (2, 4), (1, 8)], ids=str)
def test_dense_best_hits_equal_jax(shape):
    queries, profiles = _dense_case()
    ref_best, ref_score = jsharded.dense_best_hits(queries, profiles)
    mesh = None if shape is None else cpu_mesh(*shape)
    best, score = tsharded.dense_best_hits(queries, profiles, mesh=mesh, device="cpu")
    np.testing.assert_array_equal(best, ref_best)
    np.testing.assert_array_equal(score, ref_score)
    assert best[7] == 1


def test_predict_windows_on_mesh_equals_no_mesh():
    rng = np.random.default_rng(3)
    model = tig.IglooClassifier(tiny_params(rng, L=tig.WINDOW_TOKENS), device="cpu", dtype=torch.float32)
    bases = random_base_codes(rng, 7)
    ref = tpipe.predict_windows(model, bases, batch_size=4)
    progress = []
    got = tpipe.predict_windows(model, bases, batch_size=3, progress=lambda d, t: progress.append((d, t)), mesh=cpu_mesh(2, 1))
    # windows 0-3 and 4-6 over 2 cells, batch 3 padded to 4: 2 rows a batch
    assert progress == [(1, 4), (2, 4), (3, 4), (4, 4)]
    assert got.shape == (7, 3) and got.dtype == np.float32
    # windows are independent: each row is the unsharded run's
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    one_cell = tpipe.predict_windows(model, bases, batch_size=4, mesh=cpu_mesh(1, 1))
    np.testing.assert_array_equal(one_cell, ref)
    assert model.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# tests/test_multihost.py: two processes, one gloo group, a (2, 2) mesh
# ---------------------------------------------------------------------------


def _multihost_case():
    """tests/multihost_worker.py's DB and queries: > 256 profiles and
    integral scores, the prefiltered branch."""
    db = ProfileDB.synthetic(seed=4, n_profiles=300, min_len=40, max_len=120, integral=True)
    rng = np.random.default_rng(5)
    names, seqs = [], []
    for qi in range(8):
        seq = db.consensus(int(rng.integers(0, db.n_profiles))).copy()
        pos = rng.choice(len(seq), max(1, len(seq) // 10), replace=False)
        seq[pos] = rng.integers(0, N_AA, len(pos))
        names.append(f"q{qi}")
        seqs.append("".join(ALPHABET[r] for r in seq))
    return db, names, seqs


def multihost_worker(out: str) -> None:
    """One rank of the two-process test: the search and the dense best hits
    on the global (2, 2) mesh, written to ``out``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    assert tmesh.initialize_distributed()
    assert dist.get_world_size() == 2
    n_data, n_db = tmesh.balanced_factorization(4)
    mesh = tmesh.make_mesh(n_data, n_db, devices=["cpu"] * 4)
    assert len(mesh.rank_cells) == 2
    # the default: one cell per rank, each rank's own
    default = tannotate.default_search_mesh()
    assert default.shape == {"data": 1, "db": 2} and default.rank_cells == [(0, dist.get_rank())]
    db, names, seqs = _multihost_case()
    hits = tps.search(names, seqs, _twin(db), mesh=mesh)
    best, score = tsharded.dense_best_hits(*_dense_case(), mesh=mesh)
    with open(out, "w") as f:
        json.dump({"hits": {q: list(v) for q, v in hits.items()}, "best": best.tolist(), "score": score.tolist()}, f)
    dist.destroy_process_group()


def test_two_process_gloo_search(tmp_path):
    outs = spawn_ranks("tests.test_torch_mesh.multihost_worker", tmp_path)
    results = [json.loads(o.read_text()) for o in outs]
    # both ranks hold the identical global result
    assert results[0] == results[1]
    hits = results[0]["hits"]
    assert hits, "expected at least one hit from planted queries"
    db, names, seqs = _multihost_case()
    single = tps.search(names, seqs, _twin(db), device="cpu")
    assert {q: list(v) for q, v in single.items()} == hits
    assert_hits_equivalent({q: tuple(v) for q, v in hits.items()}, jps.search(names, seqs, db))
    best, score = tsharded.dense_best_hits(*_dense_case(), device="cpu")
    assert results[0]["best"] == best.tolist() and results[0]["score"] == score.tolist()


def test_search_counts_cell_launches_only_on_the_card():
    """``Mesh.cell_launches`` attributes K1's launches to the cells; the
    CPU's plain version launches nothing."""
    db = ProfileDB.synthetic(seed=7, n_profiles=40, min_len=40, max_len=80)
    names, seqs = _make_queries(db, 6, seed=1)
    mesh = cpu_mesh(2, 2)
    tps.search(names, seqs, _twin(db), mesh=mesh)
    assert set(mesh.cell_launches) <= set(mesh.rank_cells)
    assert sum(mesh.cell_launches.values()) == 0
