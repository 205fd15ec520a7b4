"""The plain references against the port's plain versions on the CPU, and
the control against the references."""

import numpy as np
import pytest
import torch

from benchmark import generator
from benchmark import manifest as mf
from benchmark.reference import igloo, provirus, sw

W = igloo.widths(mf.config("genomad-nn"))


def test_sw_matches_the_ports_plain_version():
    from genomad_torch.ops.sw import _gather_operands, sw_forward_plain

    rng = np.random.default_rng(0)
    qs = [rng.integers(0, 21, int(rng.integers(5, 70))) for _ in range(24)]
    ps = [np.round(rng.normal(-1, 3, (int(rng.integers(5, 60)), 20))) for _ in range(24)]
    best, end_i, end_j, start_j = sw.align(qs, ps)
    Q = torch.full((24, max(map(len, qs))), 20, dtype=torch.int32)
    P = torch.zeros((24, max(map(len, ps)), 21))
    for k in range(24):
        Q[k, : len(qs[k])] = torch.from_numpy(qs[k])
        P[k, : len(ps[k]), :20] = torch.from_numpy(ps[k])
    b, i, j = sw_forward_plain(Q, P)
    idx = torch.arange(24, dtype=torch.int32).repeat(2, 1)
    _, _, rj = sw_forward_plain(*_gather_operands(Q, P, idx, torch.stack([i, j])))
    assert np.array_equal(best, b.numpy()) and np.array_equal(end_i, i.numpy())
    assert np.array_equal(end_j, j.numpy()) and np.array_equal(start_j, (j - rj).numpy())


def test_bitscore_and_evalue_follow_the_ports_conventions():
    from genomad_torch.ops import protein_search as ps

    scores = np.arange(20, 200, 7.0)
    assert np.array_equal(sw.int_bitscore(scores), ps.int_bitscore(scores))
    assert np.allclose(sw.reported_evalue(sw.int_bitscore(scores), 300, 10**7), ps.evalue_from_bits(ps.int_bitscore(scores), 300, 10**7))


def test_weights_and_encoding_match_the_port():
    from genomad_torch.models import igloo as port
    from genomad_torch.ops import nn_pipeline

    a, b = port.init_params(0), igloo.init_params(W, 0)
    assert all(np.array_equal(a[g][k], b[g][k]) for g in a for k in a[g])
    job = generator.make_job(mf.traffic("metagenome-random"), {"sample_mbp": 0.1}, 3, 0)
    path = __import__("pathlib").Path(__import__("tempfile").mkdtemp()) / "s.fna"
    job.write_fasta(path)
    bases, names, ids = nn_pipeline.encode_windows(path)
    want = igloo.encode_windows(job.records, W)
    assert np.array_equal(bases, want[0]) and list(names) == want[1] and np.array_equal(ids, want[2])
    assert igloo.window_count(job.records, W) == len(bases)


@pytest.fixture(scope="module")
def windows():
    rng = np.random.default_rng(1)
    bases = rng.integers(0, 4, (4, 6000)).astype(np.uint8)
    bases[1, 100:300] = 4
    bases[2, 3000:] = 4
    return bases


def test_the_forward_matches_the_ports_float32_forward(windows):
    from genomad_torch.models import igloo as port

    torch.set_num_threads(4)
    raw = igloo.init_params(W, 0)
    want = igloo.Reference(raw, W, "cpu").forward_bases(windows)
    with torch.inference_mode():
        got = port.IglooClassifier(raw, device="cpu", dtype=torch.float32).forward_bases(torch.from_numpy(windows)).numpy()
    assert np.abs(got - want).max() < 1e-5


def test_the_control_is_far_from_the_reference(windows):
    from genomad_torch.models import igloo as port

    raw = igloo.init_params(W, 0)
    want = igloo.Reference(raw, W, "cpu").forward_bases(windows)
    control = igloo.Reference(raw, W, "cpu", quantize=True).forward_bases(windows)
    with torch.inference_mode():
        bf16 = port.IglooClassifier(raw, device="cpu", dtype=torch.bfloat16).forward_bases(torch.from_numpy(windows)).numpy()
    limit = mf.config("genomad-nn")["limits"]["nn_score_gap"]
    assert np.abs(bf16 - want).max() < limit < np.abs(control - want).max()


def _tables(seed: int, n: int = 40):
    """Random contigs of genes as both sides read them: runs of virus and
    chromosome markers among plain genes, with integrases and tRNAs."""
    from genomad_torch.modules.find_proviruses import GeneTable

    rng = np.random.default_rng(seed)
    for k in range(n):
        genes = int(rng.integers(5, 120))
        phage = rng.random(genes) < np.where(np.arange(genes) % 40 < 18, 0.6, 0.05)
        host = ~phage & (rng.random(genes) < 0.25)
        lengths = rng.integers(300, 1500, genes)
        starts = np.cumsum(lengths + rng.integers(30, 3000, genes)) - lengths + 1
        ends = starts + lengths - 1
        spm_v = np.where(phage, 0.9, np.where(host, 0.1, 0.0))
        spm_c = np.where(phage, 0.1, np.where(host, 0.9, 0.0))
        integrase = rng.random(genes) < 0.04
        trnas = [(int(s), int(s) + 75) for s in rng.integers(1, int(ends[-1]), int(rng.integers(0, 3)))]
        table = GeneTable(f"c{k}", starts.tolist(), ends.tolist(), spm_c.tolist(), spm_v.tolist(),
                          (np.exp(spm_v) - np.exp(spm_c)).tolist(), host.tolist(), phage.tolist(), integrase.tolist(),
                          [t[0] for t in trnas], [t[1] for t in trnas])
        yield table, provirus.Contig(f"c{k}", starts, ends, spm_c, spm_v, host, phage, integrase, trnas)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_provirus_decode_matches_the_ports_plain_version(seed):
    from genomad_torch.models import crf
    from genomad_torch.modules import find_proviruses as fp

    found = 0
    for table, contig in _tables(seed):
        want = provirus.proviruses(contig)
        got = []
        if table.n_c_markers and table.n_v_markers:
            scores = crf.score_provirus_genes_batch([table.spm_v], [table.spm_c], device="cpu")[0]
            assert np.abs(scores - provirus.scores(contig)).max() < 1e-4
            labels = fp.tag_provirus_genes(scores, 0.4, table)
            labels = fp.extend_provirus_edges(labels, table, "integrase", 10_000)
            labels = fp.extend_provirus_edges(labels, table, "trna", 5_000)
            if len(set(labels)) > 1:
                got = [(table.seq_name, p.start, p.end, p.n_genes, p.v_vs_c_score, p.is_edge, tuple(i + 1 for i in p.integrase_indices))
                       for p in fp.yield_proviruses(table, labels, 12.0, 8.0, 8.0)]
        assert [w[:4] + w[5:] for w in want] == [g[:4] + g[5:] for g in got]
        assert np.allclose([w[4] for w in want], [g[4] for g in got])
        found += len(want)
    assert found >= 10
