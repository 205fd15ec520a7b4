"""The long-tail DB (``dbsynth_longtail``), the readers of the long body's
metrics and of the windows' fill, the short-contig mix, and the
``e2e.longtail-db`` cell at a size the CPU holds, sound and with K1's long
body broken underneath."""

import json

import numpy as np
import pytest

from benchmark import dbsynth, dbsynth_longtail, generator
from benchmark import manifest as mf
from benchmark import run, tracing
from benchmark.reference import igloo

from conftest import TINY_LIMITS

RECIPE = {"profiles": 3000, "seed": 5, "lengths": {"median": 267, "sigma": 0.7, "min": 60, "max": 32768},
          "integrase_profiles": 16, "integrase_seed": 99, "integrase_len": [60, 90]}
WIDTHS = igloo.widths(mf.config("genomad-nn"))


def test_the_longtail_db_is_its_seeds_and_draws_the_stated_median(tmp_path):
    a, written = dbsynth_longtail.ensure_db("genomad-e2e-longtail", RECIPE, tmp_path / "a")
    b, _ = dbsynth_longtail.ensure_db("genomad-e2e-longtail", RECIPE, tmp_path / "b")
    assert written
    with np.load(a.profiles_file()) as x, np.load(b.profiles_file()) as y:
        for key in ("names", "lengths", "taxids", "pssm", "offsets"):
            assert np.array_equal(x[key], y[key]), key
        lengths, pssm, offsets = x["lengths"], x["pssm"], x["offsets"]
    assert np.array_equal(lengths, dbsynth_longtail.lengths(RECIPE))
    assert abs(np.median(lengths) / 267 - 1) < 0.05
    assert lengths.min() >= 60 and (lengths > 1024).mean() > 0.01
    assert pssm.dtype == np.int8 and np.array_equal(a.consensus(11), pssm[offsets[11] : offsets[12]].argmax(1))
    # the integrase DB and the metadata are dbsynth's
    ref, _ = dbsynth.ensure_db("genomad-e2e", {**RECIPE, "min_len": 60, "max_len": 400}, tmp_path / "c")
    for i in range(16):
        assert np.array_equal(a.integrase_consensus[i], ref.integrase_consensus[i])
    assert (a.db_dir / "genomad_marker_metadata.tsv").read_text() == (ref.db_dir / "genomad_marker_metadata.tsv").read_text()


def test_the_longtail_db_is_written_anew_for_another_recipe(tmp_path):
    _, written = dbsynth_longtail.ensure_db("genomad-e2e-longtail", RECIPE, tmp_path)
    assert written
    assert not dbsynth_longtail.ensure_db("genomad-e2e-longtail", RECIPE, tmp_path)[1]
    other = {**RECIPE, "lengths": {**RECIPE["lengths"], "sigma": 0.5}}
    db, written = dbsynth_longtail.ensure_db("genomad-e2e-longtail", other, tmp_path)
    assert written and json.loads((db.base / "READY").read_text()) == other
    assert not np.array_equal(dbsynth_longtail.lengths(other), dbsynth_longtail.lengths(RECIPE))


def test_the_configuration_states_the_published_median():
    config = mf.config("genomad-e2e-longtail")
    e2e = mf.config("genomad-e2e")
    assert config["db"]["lengths"] == {"median": 267, "sigma": 0.7, "min": 60, "max": 32768}
    assert config["source"] != e2e["source"]
    differ = {k for k in e2e if e2e[k] != config.get(k)}
    assert differ == {"name", "source", "entry", "deployment", "db", "assumed"}


def _ctx(counters, device_ops=()):
    return run.Context(None, tracing.DeviceTrace(list(device_ops), 0.0, 10.0), counters, 2.0, 0, 10.0, WIDTHS)


def test_the_long_body_readers():
    counters = {"stats.cells_forward": 3e9, "stats.cells_reverse": 1e9,
                "stats.cells_forward_long": 1.5e9, "stats.cells_reverse_long": 0.5e9}
    ops = [("void sw_slab_kernel<__nv_bfloat16, 16>(...)", 1.0, 3.0), ("void sw_chunk_kernel<float, 12>(...)", 3.0, 4.0)]
    share = mf.metric_reader("e2e.long_cell_share")
    roofline = mf.metric_reader("e2e.k1_long_roofline")
    assert share(_ctx(counters)) == pytest.approx(50.0)
    assert roofline(_ctx(counters, ops)) == pytest.approx(100.0 * 2e9 * 12 / 33.5e12 / 2.0)
    # a program without the long counters, or no long body in the trace: nothing to read
    old = {k: v for k, v in counters.items() if "long" not in k}
    assert share(_ctx(old)) is None and roofline(_ctx(old, ops)) is None
    assert roofline(_ctx(counters, ops[1:])) is None
    assert share(_ctx({**counters, "stats.cells_forward_long": 0.0, "stats.cells_reverse_long": 0.0})) == 0.0


def test_the_window_fill_reader():
    read = mf.metric_reader("nn.window_fill_share")
    assert read(_ctx({"stats.nn.window_bp": 9000.0, "stats.nn.windows": 3.0})) == pytest.approx(50.0)
    assert read(_ctx({"stats.nn.windows": 3.0})) is None


def test_short_contigs_are_one_window_each():
    mix = mf.traffic("metagenome-short")
    job = generator.make_job(mix, mf.config("genomad-nn"), 2**31 + 3, 0)
    lengths = np.array([len(s) for _, s in job.records])
    assert 4_000_000 - 1000 < lengths.sum() <= 4_000_000 and 1_600 < len(lengths) < 2_000  # a last piece under 1 kbp is dropped
    assert lengths.min() >= 1000 and lengths.max() <= 5999
    assert abs(np.median(lengths) / 2000 - 1) < 0.05
    windows = igloo.window_count(job.records[:200], WIDTHS)
    assert windows == 200


# The cell at a size the CPU holds: 300 profiles of a law near the
# configuration's (median 300, sigma 1.0: 37 of them above 1,024 columns, up
# to 2,000), so that the host-virus-host contig's 34 consensus genes reach
# the long buckets 7 times, 4 of them where a raw score 1 lower rounds to
# another bitscore (a step of 1 moves it by 0.385 bits); an 80 kbp job, on
# which the gene caller trains well enough; a warm-up job without that
# contig. The CPU pads every pair of a bucket to its bound, so the run
# takes about two minutes.
TINY_LONG_DB = {"profiles": 300, "seed": 4, "lengths": {"median": 300, "sigma": 1.0, "min": 60, "max": 2000},
                "integrase_profiles": 16, "integrase_seed": 99, "integrase_len": [60, 90]}
TINY_LONG = {"config": {"sample_mbp": 0.08, "check_jobs_within": 2, "db": TINY_LONG_DB, "limits": TINY_LIMITS},
             "traffic": {"pool_jobs": 2, "warm_up_mbp": 0.004, "warm_up": {"hvh_contigs": 0}}}


def _tiny_longtail(tmp_path, seed=5):
    import torch

    torch.set_num_threads(4)
    return run.run_cell("e2e.longtail-db", seed, 0.01, False, device="cpu", overrides=TINY_LONG, workdir=tmp_path)


def test_the_long_body_lowered_by_one_is_found(tmp_path, monkeypatch):
    """K1's long body (the profile buckets above 1,024 columns) returns
    every forward score less 1: the bitscores of the long hits differ from
    the reference's, and every other check of the run holds (the sound
    cell's runs are on the card)."""
    from genomad_torch.ops import protein_search
    from genomad_torch.ops.sw import _CHUNK_MAX_LP

    original = protein_search.sw_pairs

    def lowered(all_q, all_p, idx, ends=None, lengths=None):
        best, end_i, end_j = original(all_q, all_p, idx, ends, lengths)
        if ends is None and all_p.shape[1] > _CHUNK_MAX_LP:
            best = best - 1.0
        return best, end_i, end_j

    monkeypatch.setattr(protein_search, "sw_pairs", lowered)
    broken = _tiny_longtail(tmp_path)
    checks = broken["checks"]
    assert not broken["correct"] and broken["judged"]["long_hits"] >= 1
    assert checks["hits_differing"]["value"] + checks["planted_hits_missed"]["value"] > 0
    others = {k: c for k, c in checks.items() if k not in ("hits_differing", "planted_hits_missed")}
    assert all(c["value"] <= c["limit"] for c in others.values()), others
