"""The port's annotate module (gene calling, the marker search with K1
through its plain version, the genes and taxonomy tables) writes files
byte-equal to the JAX module's on the synthetic DB fixture; resume and
--restart behave as in JAX; and the ``genomad-torch annotate`` command."""

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from genomad_torch import cli as tcli
from genomad_torch.modules import annotate as tann
from genomad_torch.paths import GenomadOutputs
from genomad_tpu.modules import annotate as jann
from genomad_tpu.ops.profiledb import ALPHABET
from tests.test_gene_calling import make_gene, random_intergenic

torch.set_num_threads(2)

FILES = (
    "annotate_proteins_output",
    "annotate_mmseqs2_output",
    "annotate_genes_output",
    "annotate_taxonomy_output",
)


@pytest.fixture
def planted_contig(tmp_path, synthetic_db_dir):
    """The contig of test_annotate: a gene whose protein is profile 7's
    consensus, plus a second contig with profile 12's consensus gene."""
    db_dir, db = synthetic_db_dir
    rng = np.random.default_rng(3)
    records = []
    for name, pid in (("ctg1", 7), ("ctg2", 12)):
        protein = "M" + "".join(ALPHABET[r] for r in db.consensus(pid))
        records.append((name, random_intergenic(rng, 120) + make_gene(protein[1:]) + random_intergenic(rng, 120)))
    path = tmp_path / "sample.fna"
    path.write_text("".join(f">{h}\n{s}\n" for h, s in records))
    return path, db_dir, db


def _read(out_dir):
    outputs = GenomadOutputs("sample", out_dir)
    return {name: getattr(outputs, name).read_bytes() for name in FILES}


def test_annotate_files_equal_jax(tmp_path, planted_contig):
    fasta, db_dir, db = planted_contig
    jann.main(fasta, tmp_path / "jax", db_dir, verbose=False)
    tann.main(fasta, tmp_path / "torch", db_dir, verbose=False, device="cpu")
    ref, got = _read(tmp_path / "jax"), _read(tmp_path / "torch")
    for name in FILES:
        assert got[name] == ref[name], name
    genes = got["annotate_genes_output"].decode().splitlines()
    rows = [line.split("\t") for line in genes[1:]]
    assert all(len(r) == 20 for r in rows)
    assert {r[8] for r in rows} >= {str(db.names[7]), str(db.names[12])}  # both planted markers hit


def test_annotate_resume_and_restart(tmp_path, planted_contig):
    fasta, db_dir, _ = planted_contig
    out = tmp_path / "torch"
    tann.main(fasta, out, db_dir, verbose=False, device="cpu")
    outputs = GenomadOutputs("sample", out)
    first = _read(out)
    stamp = outputs.annotate_proteins_output.stat().st_mtime_ns
    # rerun: the previous execution is detected and the gene calling and
    # search steps are skipped
    tann.main(fasta, out, db_dir, verbose=False, device="cpu")
    assert outputs.annotate_proteins_output.stat().st_mtime_ns == stamp
    log = outputs.annotate_log.read_text()
    assert "Previous execution detected" in log and "Skipping protein annotation" in log
    assert _read(out) == first
    # --restart recomputes every step
    outputs.annotate_mmseqs2_output.write_text("")
    tann.main(fasta, out, db_dir, verbose=False, device="cpu", restart=True)
    assert outputs.annotate_proteins_output.stat().st_mtime_ns != stamp
    assert _read(out) == first


def test_annotate_without_device_raises_without_cuda(tmp_path, planted_contig):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    fasta, db_dir, _ = planted_contig
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tann.main(fasta, tmp_path / "out", db_dir, verbose=False)
    assert not (tmp_path / "out").exists()


def test_annotate_cli_equals_jax(tmp_path, planted_contig, monkeypatch):
    """``genomad-torch annotate IN OUT DB`` with the same options as the
    JAX CLI (which has no device option; the device resolves to the CPU
    here)."""
    fasta, db_dir, _ = planted_contig
    monkeypatch.setattr(tann, "resolve_device", lambda device=None: torch.device("cpu"))
    from genomad_tpu import cli as jcli

    args = ["annotate", str(fasta), None, str(db_dir), "--quiet", "-t", "2", "--evalue", "1e-5", "-s", "5.0"]
    for runner_cli, out in ((jcli.cli, tmp_path / "jax"), (tcli.cli, tmp_path / "torch")):
        result = CliRunner().invoke(runner_cli, [str(out) if a is None else a for a in args])
        assert result.exit_code == 0, result.output
    assert _read(tmp_path / "torch") == _read(tmp_path / "jax")
