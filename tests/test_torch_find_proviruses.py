"""The port's find-proviruses module against the JAX package's on the CPU:
the island, edge and acceptance rules on the unit cases of
``tests/test_find_proviruses.py``, and the whole module (after annotate) on
the host-virus-host contig and on the integrase contig of
``tests/test_integrase_extension.py``, whose output files must be
byte-equal: provirus TSV, FNA, FAA, genes TSV, taxonomy, the integrase
search TSV (K1 through its plain version, all-pairs path) and the tRNA
TSV."""

import numpy as np
import pytest
import torch

from genomad_torch.modules import annotate as tann
from genomad_torch.modules import find_proviruses as tfp
from genomad_torch.paths import GenomadOutputs
from genomad_tpu.modules import annotate as jann
from genomad_tpu.modules import find_proviruses as jfp
from genomad_tpu.ops.profiledb import ALPHABET, ProfileDB
from tests.test_gene_calling import make_gene, random_intergenic

torch.set_num_threads(2)

FILES = (
    "find_proviruses_output",
    "find_proviruses_nucleotide_output",
    "find_proviruses_proteins_output",
    "find_proviruses_genes_output",
    "find_proviruses_taxonomy_output",
    "find_proviruses_mmseqs2_output",
)


def _genetable(module, spm_pairs, integrases=(), trnas=()):
    """The gene table of tests/test_find_proviruses.py ``make_genetable``,
    built with ``module``'s GeneTable."""
    gt = module.GeneTable("ctg")
    for i, (spm_c, spm_v) in enumerate(spm_pairs):
        start = i * 1000 + 1
        gt.starts.append(start)
        gt.ends.append(start + 899)
        gt.spm_c.append(spm_c)
        gt.spm_v.append(spm_v)
        gt.v_vs_c_score.append(float(np.exp(spm_v) - np.exp(spm_c)))
        gt.c_markers.append(spm_c > spm_v)
        gt.v_markers.append(spm_v > spm_c)
        gt.integrases.append(i in integrases)
    for s, e in trnas:
        gt.trna_starts.append(s)
        gt.trna_ends.append(e)
    return gt


H, V, Z = (0.9, 0.0), (0.0, 0.9), (0.0, 0.0)

# (kind, spm pairs, argument, expected) from tests/test_find_proviruses.py:108-174
ISLAND_CASES = {
    "absorbs_small_phage_island": ("tag", [H] * 6 + [V] * 3 + [H] * 6, [0.0] * 6 + [0.9] * 3 + [0.0] * 6, [0] * 15),
    "keeps_large_phage_island": ("tag", [H] * 6 + [V] * 6 + [H] * 6, [0.0] * 6 + [0.9] * 6 + [0.0] * 6, [0] * 6 + [1] * 6 + [0] * 6),
    "absorbs_small_host_island": (
        "tag", [H] * 6 + [V] * 5 + [H] + [Z] * 2 + [V] * 5 + [H] * 6,
        [0.0] * 6 + [0.9] * 5 + [0.0] * 3 + [0.9] * 5 + [0.0] * 6, [0] * 6 + [1] * 13 + [0] * 6,
    ),
    "extends_to_integrase": ("integrase", [H] * 6 + [V] * 6 + [Z] * 2 + [H] * 4, [0] * 6 + [1] * 6 + [0] * 6, [0] * 6 + [1] * 8 + [0] * 4),
    "extension_blocked_by_chromosome_marker": (
        "integrase", [H] * 6 + [V] * 6 + [H] + [Z] + [H] * 4, [0] * 6 + [1] * 6 + [0] * 8, [0] * 6 + [1] * 6 + [0] * 8,
    ),
    "extends_to_trna": ("trna", [H] * 6 + [V] * 6 + [Z] * 4, [0] * 6 + [1] * 6 + [0] * 4, None),
    "mid_island_below_threshold": ("accept", [Z] * 3 + [V] * 6 + [Z] * 3, [0] * 3 + [1] * 6 + [0] * 3, []),
    "edge_island_passes_edge_threshold": ("accept", [V] * 6 + [Z] * 6, [1] * 6 + [0] * 6, [(1, 5900, True, "ctg|provirus_1_5900")]),
    "integrase_island_passes_integrase_threshold": ("accept", [Z] * 3 + [V] * 6 + [Z] * 3, [0] * 3 + [1] * 6 + [0] * 3, "integrase"),
}


@pytest.mark.parametrize("case", sorted(ISLAND_CASES))
def test_island_edge_and_threshold_rules_match_jax(case):
    kind, spm, arg, expected = ISLAND_CASES[case]
    integrases = {13} if kind == "integrase" else ({5} if expected == "integrase" else set())
    trnas = [(14_001, 14_080)] if kind == "trna" else []
    results = []
    for module in (jfp, tfp):
        gt = _genetable(module, spm, integrases, trnas)
        if kind == "tag":
            out = module.tag_provirus_genes(np.array(arg), 0.4, gt)
        elif kind in ("integrase", "trna"):
            out = module.extend_provirus_edges(list(arg), gt, kind, 10_000 if kind == "integrase" else 5_000)
        else:
            out = [(p.start, p.end, p.is_edge, p.provirus_name, p.has_integrase, p.integrase_indices, round(p.v_vs_c_score, 12))
                   for p in module.yield_proviruses(gt, list(arg), 12.0, 8.0, 8.0)]
        results.append(out)
    assert results[1] == results[0]
    got = results[1]
    if expected == "integrase":
        assert len(got) == 1 and got[0][4] and got[0][5] == [5]  # the contig's gene index
    elif kind == "accept":
        assert [g[:4] for g in got] == expected
    elif expected is not None:
        assert got == expected
    else:  # the tRNA 2 kb past the island is absorbed
        assert got[12:14] == [1, 1] and got[:6] == [0] * 6


def _gene_for(db, p):
    return make_gene("".join(ALPHABET[r] for r in db.consensus(p)))


def _host_virus_host(db, rng):
    host, virus = [0, 2, 4, 6, 8, 10, 12], [1, 3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23]
    parts = [random_intergenic(rng, 60)]
    for p in host + virus + host:
        parts += [_gene_for(db, p), random_intergenic(rng, 30)]
    return "".join(parts)


def _integrase_contig(db, integrase_db, rng):
    host = [0, 2, 4, 6, 8, 10]
    parts = [random_intergenic(rng, 60)]
    for p in host + [1, 3, 5, 7, 9, 11, 13]:
        parts += [_gene_for(db, p), random_intergenic(rng, 30)]
    parts += [_gene_for(integrase_db, 0), random_intergenic(rng, 30)]
    for p in host:
        parts += [_gene_for(db, p), random_intergenic(rng, 30)]
    return "".join(parts)


def _run_both(tmp_path, db_dir, seq, **options):
    fasta = tmp_path / "sample.fna"
    fasta.write_text(f">ctg1\n{seq}\n")
    for name, ann, fp, extra in (("jax", jann, jfp, {}), ("torch", tann, tfp, {"device": "cpu"})):
        ann.main(fasta, tmp_path / name, db_dir, verbose=False, **extra)
        fp.main(fasta, tmp_path / name, db_dir, verbose=False, **options, **extra)
    return GenomadOutputs("sample", tmp_path / "jax"), GenomadOutputs("sample", tmp_path / "torch")


def _assert_files_equal(ref, got, names):
    for name in names:
        assert getattr(got, name).read_bytes() == getattr(ref, name).read_bytes(), name


def test_host_virus_host_files_equal_jax(tmp_path, synthetic_db_dir):
    db_dir, db = synthetic_db_dir
    seq = _host_virus_host(db, np.random.default_rng(7))
    ref, got = _run_both(tmp_path, db_dir, seq, marker_threshold=6.0)
    _assert_files_equal(ref, got, FILES + ("find_proviruses_aragorn_output",))
    lines = got.find_proviruses_output.read_text().splitlines()
    assert len(lines) >= 2 and lines[1].split("\t")[1] == "ctg1"  # a provirus was found


def test_integrase_contig_files_equal_jax(tmp_path, synthetic_db_dir):
    db_dir, db = synthetic_db_dir
    integrase_db = ProfileDB.load(db_dir / "genomad_integrase_profiles.npz")
    seq = _integrase_contig(db, integrase_db, np.random.default_rng(23))
    ref, got = _run_both(
        tmp_path, db_dir, seq, skip_trna_identification=True,
        marker_threshold=4.0, marker_threshold_integrase=4.0, marker_threshold_edge=4.0,
    )
    _assert_files_equal(ref, got, FILES)
    assert got.find_proviruses_mmseqs2_output.stat().st_size > 0  # the integrase search hit
    fields = got.find_proviruses_output.read_text().splitlines()[1].split("\t")
    assert fields[8] != "NA"  # the provirus carries its integrase gene


def test_resume_skips_the_integrase_search(tmp_path, synthetic_db_dir):
    db_dir, db = synthetic_db_dir
    fasta = tmp_path / "sample.fna"
    fasta.write_text(f">ctg1\n{_host_virus_host(db, np.random.default_rng(7))}\n")
    out = tmp_path / "out"
    tann.main(fasta, out, db_dir, verbose=False, device="cpu")
    options = dict(verbose=False, device="cpu", skip_trna_identification=True, marker_threshold=6.0)
    tfp.main(fasta, out, db_dir, **options)
    outputs = GenomadOutputs("sample", out)
    first = {name: getattr(outputs, name).read_bytes() for name in FILES}
    stamp = outputs.find_proviruses_mmseqs2_output.stat().st_mtime_ns
    tfp.main(fasta, out, db_dir, **options)
    assert outputs.find_proviruses_mmseqs2_output.stat().st_mtime_ns == stamp
    assert "Skipping integrase search" in outputs.find_proviruses_log.read_text()
    tfp.main(fasta, out, db_dir, restart=True, **options)
    assert outputs.find_proviruses_mmseqs2_output.stat().st_mtime_ns != stamp
    assert {name: getattr(outputs, name).read_bytes() for name in FILES} == first
