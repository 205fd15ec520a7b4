"""The traffic generator: the same seed gives the same jobs, with the sizes
and shares its data files state."""

import numpy as np
import pytest

from benchmark import dbsynth, generator
from benchmark import manifest as mf

from conftest import TINY_DB


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return dbsynth.ensure_db("genomad-e2e", TINY_DB, tmp_path_factory.mktemp("cache"))[0]


_CODON = {codon: aa for aa, codons in generator.SYNONYMS.items() for codon in codons}


def translate(cds: str) -> str:
    return "".join(_CODON[cds[i : i + 3]] for i in range(0, len(cds) - 2, 3))


def _config(mbp):
    return {**mf.config("genomad-e2e"), "sample_mbp": mbp}


def test_db_is_made_once_and_reads_back(db, tmp_path_factory):
    again, written = dbsynth.ensure_db("genomad-e2e", TINY_DB, db.base.parent)
    assert not written
    pssms, lengths = dbsynth.load_profiles(db.profiles_file(), [0, 7])
    assert len(lengths) == 400 and 60 <= lengths.min() and lengths.max() <= 400
    assert np.array_equal(pssms[1].argmax(1), db.consensus(7))
    assert np.all(pssms[0] == np.round(pssms[0]))
    assert (db.db_dir / "genomad_mini_profiles.npz").resolve() == db.profiles_file().resolve()


@pytest.mark.parametrize("mix", ["metagenome-genes", "metagenome-random", "isolate-prophages"])
def test_same_seed_same_jobs(mix, db):
    t = mf.traffic(mix)
    a = generator.make_job(t, _config(0.05), 2**31 + 9, 3, db)
    b = generator.make_job(t, _config(0.05), 2**31 + 9, 3, db)
    c = generator.make_job(t, _config(0.05), 2**31 + 10, 3, db)
    assert a.records == b.records and a.planted == b.planted
    assert a.records != c.records


def test_random_contigs_sizes():
    t = mf.traffic("metagenome-random")
    job = generator.make_job(t, {"sample_mbp": 2}, 4, 0)
    lengths = [len(s) for _, s in job.records]
    assert sum(lengths) == 2_000_000
    assert min(lengths[:-1]) >= 1500 and max(lengths) <= 150_000
    assert 4000 < np.median(lengths) < 9000
    assert any("N" in s for _, s in job.records)


def test_gene_contigs_plant_markers(db):
    t = mf.traffic("metagenome-genes")
    job = generator.make_job(t, _config(0.2), 6, 1, db)
    seqs = dict(job.records)
    assert 0.19e6 <= job.bp <= 0.21e6
    hvh = [name for name in seqs if "_hvh" in name]
    assert len(hvh) == t["hvh_contigs"]
    plain = [p for p in job.planted if "_hvh" not in p[0]]
    n_genes = sum(s.count("AGGAGGCCCCCCCATG") for name, s in job.records if "_hvh" not in name)
    assert 0.12 < len(plain) / n_genes < 0.28
    for contig, begin, end, profile in job.planted:
        cds = seqs[contig][begin - 1 : end]
        assert cds.startswith("ATG") and cds.endswith("TAA")
        protein = translate(cds)[1:-1]
        want = db.consensus(profile)
        same = np.mean([a == "ACDEFGHIKLMNPQRSTVWY"[r] for a, r in zip(protein, want)])
        assert len(protein) == len(want) and same >= 0.88


def test_isolate_has_prophages_and_a_plasmid(db):
    t = mf.traffic("isolate-prophages")
    job = generator.make_job(t, _config(0.5), 3, 0, db)
    names = [n for n, _ in job.records]
    assert names == ["s0_chromosome", "s0_plasmid"]
    assert len(job.records[0][1]) >= 500_000 and len(job.records[1][1]) >= 50_000
    odd = sum(p % 2 for c, _, _, p in job.planted if c == "s0_chromosome")
    even = sum(1 - p % 2 for c, _, _, p in job.planted if c == "s0_chromosome")
    assert odd > 30 and even > 30
    assert len(job.prophages) == t["prophage"]["count"]
    for contig, begin, end in job.prophages:
        inside = [g for g in job.genes if g[0] == contig and begin <= g[1] and g[2] <= end]
        assert inside[0][1] == begin and inside[0][3] == generator.INTEGRASE
        assert abs(end - begin - t["prophage"]["bp"]) < 3000
        assert np.mean([g[3] >= 0 and g[3] % 2 for g in inside[1:]]) > 0.4


@pytest.mark.parametrize("mix", ["metagenome-genes", "isolate-prophages"])
def test_every_written_gene_is_recorded(mix, db):
    """The truth the gene calls are held to: each recorded gene is an open
    reading frame from its ATG to its TAA, and the recorded genes are all
    the genes the contigs hold."""
    job = generator.make_job(mf.traffic(mix), _config(0.1), 11, 2, db)
    seqs = dict(job.records)
    for contig, begin, end, profile in job.genes:
        cds = seqs[contig][begin - 1 : end]
        assert cds.startswith("ATG") and cds.endswith("TAA") and len(cds) % 3 == 0
        assert "*" not in translate(cds)[:-1]
        assert seqs[contig][begin - 14 : begin - 8] == "AGGAGG"
    assert len(job.genes) == sum(s.count("AGGAGGCCCCCCCATG") for s in seqs.values())
    assert {g[3] for g in job.genes if g[3] < 0} <= {generator.BACKGROUND, generator.INTEGRASE}
    if mix == "metagenome-genes":
        (contig, begin, end), = job.prophages
        inside = [g for g in job.genes if g[0] == contig and begin <= g[1] and g[2] <= end]
        assert len(inside) == 21 and inside[-1][3] == generator.INTEGRASE and all(g[3] % 2 for g in inside[:-1])


def test_pool_and_job_streams_are_independent(db):
    t = {**mf.traffic("metagenome-random"), "pool_jobs": 3}
    pool = generator.make_pool(t, {"sample_mbp": 0.05}, 8)
    assert [j.records for j in pool[:2]] == [generator.make_job(t, {"sample_mbp": 0.05}, 8, i).records for i in range(2)]
