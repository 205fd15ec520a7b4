"""The port's ``run_end_to_end`` (FASTA -> annotate || nn-classification ->
find-proviruses -> marker-classification -> nn provirus pass ->
aggregated-classification -> score-calibration -> summary) against the JAX
package's on the CPU, on the fixture of ``tests/test_end_to_end.py``; its
--restart determinism and resume; and the ``genomad-torch`` CLI.

Tolerances: the annotate, find-proviruses and feature files are byte-equal;
the features and marker-classification npz agree to rtol 1e-5 (f32 sums in
another order); every score that passes through the NN branch (nn,
aggregated and calibrated predictions, the summary's score and FDR columns)
agrees to atol 1e-2, the bound PR 1 stated for the bf16 NN module
(``tests/test_torch_nn_classification.py``); every other summary column
(names, coordinates, topology, gene counts, taxonomy) is byte-equal."""

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from genomad_torch import cli as tcli
from genomad_torch.paths import GenomadOutputs
from genomad_tpu import cli as jcli
from genomad_tpu.ops.profiledb import ALPHABET
from tests.test_gene_calling import make_gene, random_intergenic

torch.set_num_threads(2)

NN_ATOL = 1e-2  # bf16 NN branch (PR 1's bound for the nn-classification module)
NPZ_RTOL = 1e-5

# summary filters that keep every sequence (tests/test_end_to_end.py:40-43)
OPEN_FILTERS = dict(
    min_score=0.0, max_fdr=1.0, min_number_genes=0,
    min_plasmid_marker_enrichment=-100, min_virus_marker_enrichment=-100,
    min_plasmid_hallmarks=0, min_plasmid_hallmarks_short_seqs=0,
    min_virus_hallmarks=0, min_virus_hallmarks_short_seqs=0, max_uscg=100,
)

BYTE_EQUAL = (
    "annotate_proteins_output", "annotate_mmseqs2_output", "annotate_genes_output", "annotate_taxonomy_output",
    "find_proviruses_output", "find_proviruses_nucleotide_output", "find_proviruses_proteins_output",
    "find_proviruses_genes_output", "find_proviruses_taxonomy_output", "find_proviruses_mmseqs2_output",
    "features_output",
)
NPZ_RTOL_FILES = ("features_npz_output", "marker_classification_npz_output")
NPZ_NN_FILES = (
    "nn_classification_npz_output", "aggregated_classification_npz_output",
    "calibrated_nn_classification_npz_output", "calibrated_aggregated_classification_npz_output",
    "calibrated_marker_classification_npz_output",
)


def _gene_for(db, p):
    return make_gene("".join(ALPHABET[r] for r in db.consensus(p)))


def _two_contigs(tmp_path, db):
    """tests/test_end_to_end.py:23-34: a host-ish and a virus-ish contig,
    each long enough for one NN window."""
    rng = np.random.default_rng(11)
    contigs = []
    for profiles in ((0, 2, 4, 6, 8, 10), (1, 3, 5, 7, 9, 11)):
        c = random_intergenic(rng, 60)
        for p in profiles:
            c += _gene_for(db, p) + random_intergenic(rng, 30)
        contigs.append(c + random_intergenic(rng, 800))
    path = tmp_path / "sample.fna"
    path.write_text(f">host1\n{contigs[0]}\n>virus1\n{contigs[1]}\n")
    return path


def _npz_equal(ref_path, got_path, **tol):
    ref, got = np.load(ref_path), np.load(got_path)
    assert sorted(ref.files) == sorted(got.files), ref_path.name
    for key in ref.files:
        if ref[key].dtype.kind in "fc":
            np.testing.assert_allclose(got[key], ref[key], err_msg=f"{ref_path.name}:{key}", **tol)
        else:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{ref_path.name}:{key}")


def _summary_equal(ref_path, got_path):
    ref = [line.split("\t") for line in ref_path.read_text().splitlines()]
    got = [line.split("\t") for line in got_path.read_text().splitlines()]
    assert got[0] == ref[0] and len(got) == len(ref), ref_path.name
    scores = [i for i, name in enumerate(ref[0]) if name.endswith("_score") or name == "fdr"]
    for r, g in zip(ref[1:], got[1:]):
        assert [g[i] for i in range(len(g)) if i not in scores] == [r[i] for i in range(len(r)) if i not in scores]
        np.testing.assert_allclose([float(g[i]) for i in scores], [float(r[i]) for i in scores], atol=NN_ATOL, rtol=0)
    return len(ref) - 1


def test_run_end_to_end_matches_jax(tmp_path, synthetic_db_dir):
    db_dir, db = synthetic_db_dir
    fasta = _two_contigs(tmp_path, db)
    options = dict(verbose=False, skip_trna_identification=True, enable_score_calibration=True, **OPEN_FILTERS)
    jcli.run_end_to_end(fasta, tmp_path / "jax", db_dir, **options)
    tcli.run_end_to_end(fasta, tmp_path / "torch", db_dir, device="cpu", **options)
    ref, got = GenomadOutputs("sample", tmp_path / "jax"), GenomadOutputs("sample", tmp_path / "torch")
    for name in BYTE_EQUAL:
        assert getattr(got, name).read_bytes() == getattr(ref, name).read_bytes(), name
    for name in NPZ_RTOL_FILES:
        _npz_equal(getattr(ref, name), getattr(got, name), rtol=NPZ_RTOL, atol=0)
    for name in NPZ_NN_FILES:
        _npz_equal(getattr(ref, name), getattr(got, name), atol=NN_ATOL, rtol=0)
    assert got.score_calibration_compositions_output.read_text() == ref.score_calibration_compositions_output.read_text()
    rows = _summary_equal(ref.summary_virus_output, got.summary_virus_output)
    rows += _summary_equal(ref.summary_plasmid_output, got.summary_plasmid_output)
    assert rows >= 1  # the open filters keep every sequence somewhere
    for name in ("summary_virus_sequences_output", "summary_plasmid_sequences_output",
                 "summary_virus_genes_output", "summary_plasmid_genes_output",
                 "summary_virus_proteins_output", "summary_plasmid_proteins_output"):
        assert getattr(got, name).read_bytes() == getattr(ref, name).read_bytes(), name


def test_end_to_end_restart_deterministic_and_resume(tmp_path, synthetic_db_dir):
    """tests/test_end_to_end.py:84-126 on the port: --restart recomputes to
    identical scores, a plain re-run resumes (the NN contig pass is not
    recomputed) with the same scores."""
    db_dir, db = synthetic_db_dir
    rng = np.random.default_rng(23)
    contig = random_intergenic(rng, 60)
    for p in (1, 3, 5):
        contig += _gene_for(db, p) + random_intergenic(rng, 30)
    contig += random_intergenic(rng, 800)
    fasta = tmp_path / "sample.fna"
    fasta.write_text(f">c1\n{contig}\n")
    out = tmp_path / "out"
    kwargs = dict(verbose=False, skip_trna_identification=True, device="cpu", **OPEN_FILTERS)
    outputs = GenomadOutputs("sample", out)

    tcli.run_end_to_end(fasta, out, db_dir, **kwargs)
    agg1 = np.load(outputs.aggregated_classification_npz_output)["predictions"]
    tcli.run_end_to_end(fasta, out, db_dir, restart=True, **kwargs)
    agg2 = np.load(outputs.aggregated_classification_npz_output)["predictions"]
    np.testing.assert_array_equal(agg1, agg2)

    stamp = outputs.nn_classification_npz_output.stat().st_mtime_ns
    tcli.run_end_to_end(fasta, out, db_dir, **kwargs)
    assert outputs.nn_classification_npz_output.stat().st_mtime_ns == stamp
    np.testing.assert_array_equal(np.load(outputs.aggregated_classification_npz_output)["predictions"], agg1)


COMMANDS = (
    "download-database", "annotate", "find-proviruses", "marker-classification", "nn-classification",
    "aggregated-classification", "score-calibration", "summary", "end-to-end",
)


def test_cli_help_lists_the_nine_commands():
    result = CliRunner().invoke(tcli.cli, ["--help"])
    assert result.exit_code == 0
    for cmd in COMMANDS:
        assert cmd in result.output
    assert sorted(tcli.cli.commands) == sorted(jcli.cli.commands) == sorted(COMMANDS)


@pytest.mark.parametrize("command", COMMANDS)
def test_cli_command_options_match_jax(command):
    def options(cmd):
        return sorted((p.name, tuple(p.opts), p.default, p.is_flag if hasattr(p, "is_flag") else None) for p in cmd.params)

    assert options(tcli.cli.commands[command]) == options(jcli.cli.commands[command])


def test_cli_preset_conflicts_with_filters(tmp_path):
    (tmp_path / "in.fna").write_text(">a\nACGT\n")
    for preset in ("--conservative", "--relaxed"):
        result = CliRunner().invoke(
            tcli.cli, ["summary", str(tmp_path / "in.fna"), str(tmp_path / "out"), preset, "--min-score", "0.9"]
        )
        assert result.exit_code != 0
        assert "cannot use filtering options" in result.output


def test_presets_match_jax():
    assert tcli._FILTER_DEFAULTS == jcli._FILTER_DEFAULTS
    assert tcli._RELAXED == jcli._RELAXED and tcli._CONSERVATIVE == jcli._CONSERVATIVE


def _entry_points(tmp_path):
    from genomad_torch.models import crf, forest
    from genomad_torch.modules import find_proviruses, marker_classification
    from genomad_torch.tools import profile_forward

    fasta, out, db = tmp_path / "in.fna", tmp_path / "out", tmp_path
    return {
        "run_end_to_end": lambda: tcli.run_end_to_end(fasta, out, db, verbose=False),
        "find_proviruses": lambda: find_proviruses.main(fasta, out, db, verbose=False),
        "marker_classification": lambda: marker_classification.main(fasta, out, db, verbose=False),
        "crf": lambda: crf.score_provirus_genes([0.1], [0.2]),
        "forest": lambda: forest.synthetic_forest().predict_margin(np.zeros((1, 25), np.float32)),
        "profile_forward": lambda: profile_forward.profile_forward(2),
    }


@pytest.mark.parametrize("name", ["run_end_to_end", "find_proviruses", "marker_classification", "crf", "forest", "profile_forward"])
def test_entry_points_raise_without_cuda(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    (tmp_path / "in.fna").write_text(">a\n" + "ACGT" * 100 + "\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points(tmp_path)[name]()
    assert not (tmp_path / "out").exists()
