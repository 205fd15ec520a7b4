"""The port's public helpers that only the JAX package's own tests call,
held to their JAX functions: ``sequence.tokenize_dna`` and
``tokenize_windows`` (through ``ops.conv.tokens_from_bases``, the port's one
k-mer rule), ``protein_search.evalue`` and ``utils.check_executables``."""

import os
import stat

import numpy as np
import pytest
import torch

from genomad_torch import sequence as tseq
from genomad_torch import utils as tutils
from genomad_torch.ops import protein_search as tps
from genomad_tpu import sequence as jseq
from genomad_tpu import utils as jutils
from genomad_tpu.ops import protein_search as jps

torch.set_num_threads(2)

_ACGTN = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _dna(rng, n: int, n_share: float = 0.05) -> bytes:
    """n random bases, about ``n_share`` of them N."""
    p = np.array([1 - n_share] * 4 + [4 * n_share]) / 4
    return bytes(rng.choice(_ACGTN, n, p=p))


@pytest.mark.parametrize("word_size", [4, 1, 7, 16])
def test_tokenize_dna_equals_jax(word_size):
    """Lengths under, at and just over the word size, and long rows; the
    16-base words take the int64 path of ``tokens_from_bases``."""
    rng = np.random.default_rng(word_size)
    for n in (0, 1, word_size - 1, word_size, word_size + 1, 37, 6000):
        for n_share in (0.0, 0.05, 0.5):
            seq = _dna(rng, max(n, 0), n_share)
            got, ref = tseq.tokenize_dna(seq, word_size), jseq.tokenize_dna(seq, word_size)
            assert got.dtype == ref.dtype == np.int64
            np.testing.assert_array_equal(got, ref, err_msg=f"n={n} N share {n_share}")


def test_tokenize_dna_reads_all_but_upper_case_acgt_as_n():
    """Lower case and IUPAC codes are N to both tokenizers (no window of
    them yields a token)."""
    seq = b"ACGTacgtRYKMACGTSWBDHVNACGT"
    np.testing.assert_array_equal(tseq.tokenize_dna(seq), jseq.tokenize_dna(seq))


def test_tokenize_windows_equals_jax():
    """Windows shorter than the window length are padded with N, as the
    reference pads them; an empty window is all N."""
    rng = np.random.default_rng(3)
    windows = [_dna(rng, n) for n in (0, 3, 4, 100, 5999, 6000)]
    for word_size in (4, 6):
        got = tseq.tokenize_windows(windows, 6000, word_size)
        ref = jseq.tokenize_windows(windows, 6000, word_size)
        assert got.shape == ref.shape == (len(windows), 6000 - word_size + 1)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("lam,k", [(tps.KA_LAMBDA, tps.KA_K), (0.3176, 0.134)])
def test_evalue_equals_jax_bits(lam, k):
    """float64 E-values bit for bit over random raw scores (negative ones
    included) and query lengths."""
    rng = np.random.default_rng(8)
    raw = np.concatenate([rng.uniform(-50, 400, 2000), rng.integers(-20, 500, 2000).astype(np.float64)])
    qlen = rng.integers(30, 3000, raw.size)
    for db_positions in (1, 1_000_000, 47_651_282):
        got = tps.evalue(raw, qlen, db_positions, lam, k)
        ref = jps.evalue(raw, qlen, db_positions, lam, k)
        assert got.dtype == ref.dtype == np.float64
        np.testing.assert_array_equal(got.view(np.int64), ref.view(np.int64))
    assert tps.evalue(100.0, 300, 10**6) == jps.evalue(100.0, 300, 10**6)


def test_check_executables_equals_jax(tmp_path, monkeypatch):
    """An executable file on the PATH is found, a plain file and a missing
    name are reported, in the order given."""
    tool = tmp_path / "genomad-test-tool"
    tool.write_text("#!/bin/sh\n")
    tool.chmod(tool.stat().st_mode | stat.S_IXUSR)
    (tmp_path / "genomad-test-data").write_text("")
    monkeypatch.setenv("PATH", str(tmp_path) + os.pathsep + os.environ.get("PATH", ""))
    names = ["genomad-test-missing", "genomad-test-tool", "genomad-test-data", "sh"]
    got = tutils.check_executables(names)
    assert got == jutils.check_executables(names) == ["genomad-test-missing", "genomad-test-data"]
    assert tutils.check_executables([]) == []
