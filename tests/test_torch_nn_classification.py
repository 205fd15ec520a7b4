"""The port's nn-classification branch against the JAX package: window
encoding, batched prediction, the per-contig merge, the module with its
output files and resume rules, and the CLI command."""

import zipfile

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from genomad_torch import cli as tcli
from genomad_torch import trace
from genomad_torch.models import igloo as tig
from genomad_torch.modules import nn_classification as tnn
from genomad_torch.ops import nn_pipeline as tpipe
from genomad_torch.paths import GenomadOutputs
from genomad_tpu import cli as jcli
from genomad_tpu.modules import nn_classification as jnn
from genomad_tpu.ops import nn_pipeline as jpipe

torch.set_num_threads(2)

# bf16 module run against the JAX module's bf16 run, per-contig probabilities:
# bf16 keeps 8 significant bits (relative step 2^-8 = 0.4%); the two
# frameworks round the same values at the same points but sum in other
# orders, so single features may land on neighbouring bf16 values and the
# differences pass through three convs, two attentions and three dense
# layers. Measured on the CPU over three seeds of six contigs each: max |diff|
# 1.1e-3; 1e-2 leaves about 9x room and is still far below a change of the
# classification.
MODULE_BF16_ATOL = 1e-2


def _dna(rng, n):
    return bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)]).decode()


@pytest.fixture
def gappy_fasta(tmp_fasta, rng):
    return tmp_fasta(
        [
            ("long desc", _dna(rng, 14_000)),  # windows 6000, 6000 (2000 tail dropped)
            ("gappy", _dna(rng, 6_000) + "N" * 6_000 + _dna(rng, 3_000)),  # 6000, [all N: dropped], 3000
            ("short", "ACGT" * 300),  # 1200 bp -> single forced window
            ("flanked", "NN" + _dna(rng, 2_600) + "nnn"),  # strip_n trims the flanks
            ("mixed", _dna(rng, 3_000) + "ACGTRYN" * 200 + _dna(rng, 4_000)),
        ]
    )


@pytest.mark.parametrize("single_window", [False, True])
def test_encode_windows_equals_jax(gappy_fasta, single_window):
    ours = tpipe.encode_windows(gappy_fasta, single_window)
    ref = jpipe.encode_windows(gappy_fasta, single_window)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ours[1].tolist() == ["long", "gappy", "short", "flanked", "mixed"]


def test_segment_mean_equals_jax(rng):
    preds = rng.random((9, 3)).astype(np.float32)
    ids = np.array([0, 0, 2, 2, 2, 3, 5, 5, 5], dtype=np.int32)
    np.testing.assert_array_equal(tpipe.segment_mean(preds, ids, 6), jpipe.segment_mean(preds, ids, 6))


def test_predict_windows_pads_the_last_batch(rng):
    model = tig.IglooClassifier(tig.init_params(seed=0), device="cpu", dtype=torch.float32)
    bases = rng.integers(0, 5, size=(5, tpipe.WINDOW_LENGTH)).astype(np.uint8)
    progress = []
    out = tpipe.predict_windows(model, bases, batch_size=4, progress=lambda d, t: progress.append((d, t)))
    assert out.shape == (5, 3) and out.dtype == np.float32
    assert progress == [(1, 2), (2, 2)]
    with torch.inference_mode():
        whole = model.forward_bases(torch.from_numpy(bases)).numpy()
    # windows are independent: padding rows change nothing
    np.testing.assert_allclose(out, whole, rtol=1e-6, atol=1e-7)
    assert tpipe.predict_windows(model, bases[:0]).shape == (0, 3)


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_module_matches_jax_module(tmp_fasta, tmp_path, rng):
    records = [(f"contig{i}", _dna(rng, n)) for i, n in enumerate((7_000, 13_500, 3_100))]
    input_path = tmp_fasta(records)
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    tnn.main(input_path, ours_dir, batch_size=8, verbose=False, device="cpu")
    jnn.main(input_path, ref_dir, batch_size=8, verbose=False)

    assert _files(ours_dir) == _files(ref_dir)
    outputs, ref_outputs = GenomadOutputs("input", ours_dir), GenomadOutputs("input", ref_dir)
    ours, ref = np.load(outputs.nn_classification_npz_output), np.load(ref_outputs.nn_classification_npz_output)
    assert ours["contig_names"].tolist() == ref["contig_names"].tolist() == ["contig0", "contig1", "contig2"]
    assert ours["predictions"].shape == (3, 3)
    np.testing.assert_allclose(ours["predictions"].sum(1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(ours["predictions"], ref["predictions"], rtol=0, atol=MODULE_BF16_ATOL)
    # the window cache is the JAX module's, array for array
    cache, ref_cache = np.load(outputs.seq_window_id_output), np.load(ref_outputs.seq_window_id_output)
    assert sorted(cache.files) == sorted(ref_cache.files)
    for key in cache.files:
        np.testing.assert_array_equal(cache[key], ref_cache[key])

    lines = outputs.nn_classification_output.read_text().splitlines()
    ref_lines = ref_outputs.nn_classification_output.read_text().splitlines()
    assert lines[0] == ref_lines[0] == "seq_name\tchromosome_score\tplasmid_score\tvirus_score"
    assert [line.split("\t")[0] for line in lines] == [line.split("\t")[0] for line in ref_lines]
    for line in lines[1:]:
        assert abs(sum(float(v) for v in line.split("\t")[1:]) - 1) <= 1.5e-4  # three 4-decimal roundings


def test_module_rerun_skips(tmp_fasta, tmp_path, rng):
    input_path = tmp_fasta([(f"c{i}", _dna(rng, 6_500)) for i in range(2)])
    out_dir = tmp_path / "out"
    tnn.main(input_path, out_dir, batch_size=4, verbose=False, device="cpu")
    outputs = GenomadOutputs("input", out_dir)
    first = np.load(outputs.nn_classification_npz_output)["predictions"]
    mtime = outputs.nn_classification_npz_output.stat().st_mtime_ns

    tnn.main(input_path, out_dir, batch_size=4, verbose=False, device="cpu")
    log = outputs.nn_classification_log.read_text()
    assert "Previous execution detected" in log
    assert "Skipping sequence classification" in log
    assert outputs.nn_classification_npz_output.stat().st_mtime_ns == mtime
    np.testing.assert_array_equal(np.load(outputs.nn_classification_npz_output)["predictions"], first)

    # a changed parameter recomputes
    tnn.main(input_path, out_dir, batch_size=4, single_window=True, verbose=False, device="cpu")
    assert "Previous outputs will be overwritten" in outputs.nn_classification_log.read_text()


def test_module_writes_a_large_window_cache_in_chunks(tmp_fasta, tmp_path, rng):
    # 45 windows: 270,128 bytes of bases, more than one chunk of 256 KiB
    input_path = tmp_fasta([(f"c{i}", _dna(rng, 90_000)) for i in range(3)])
    chunks_before = trace.COUNTERS["nn.cache_chunks"]
    tnn.main(input_path, tmp_path / "out", batch_size=16, threads=4, verbose=False, device="cpu")
    assert trace.COUNTERS["nn.cache_chunks"] - chunks_before == 2

    cache_path = GenomadOutputs("input", tmp_path / "out").seq_window_id_output
    with zipfile.ZipFile(cache_path) as z:
        assert z.testzip() is None
    cache = np.load(cache_path)
    assert cache.files == ["bases", "contig_names", "contig_ids"]
    for got, expected in zip((cache[key] for key in cache.files), tpipe.encode_windows(input_path)):
        assert got.dtype == expected.dtype
        np.testing.assert_array_equal(got, expected)


def test_module_resumes_from_the_window_cache_it_wrote(tmp_fasta, tmp_path, rng):
    input_path = tmp_fasta([(f"c{i}", _dna(rng, 6_500)) for i in range(3)])
    out_dir = tmp_path / "out"
    tnn.main(input_path, out_dir, batch_size=4, verbose=False, device="cpu")
    outputs = GenomadOutputs("input", out_dir)
    first = np.load(outputs.nn_classification_npz_output)["predictions"]

    # without the scores, a rerun classifies again from the cache through the skip branch
    outputs.nn_classification_npz_output.unlink()
    tnn.main(input_path, out_dir, batch_size=4, verbose=False, device="cpu")
    log = outputs.nn_classification_log.read_text()
    assert "Previous execution detected" in log
    assert f"{outputs.seq_window_id_output.name} was found. Skipping sequence encoding." in log
    np.testing.assert_array_equal(np.load(outputs.nn_classification_npz_output)["predictions"], first)


def test_cli_command_matches_jax_options():
    def options(command):
        return sorted((p.name, tuple(p.opts), p.default) for p in command.params)

    assert options(tcli.nn_classification) == options(jcli.nn_classification)
    assert options(tcli.annotate) == options(jcli.annotate)
    assert sorted(tcli.cli.commands) == sorted(jcli.cli.commands)  # all nine commands are ported
    result = CliRunner().invoke(tcli.cli, ["nn-classification", "--help"])
    assert result.exit_code == 0 and "--batch-size" in result.output
