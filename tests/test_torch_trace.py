"""The port's tracer (``genomad_torch.trace``): spans record only while a
``torch.profiler`` session records, on every thread, with their job and
parent across the port's thread pools; ``protein_search.STATS`` is its
counter registry; the native prefilter, the search, the CRF and the
modules count and span where the work happens; the benchmark's readers of
them. One test needs the card (marker ``chip``): run it there with
``python -m pytest --noconftest tests/test_torch_trace.py -m chip``."""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import manifest as mf
from benchmark import run as bench_run
from benchmark import tracing as bench_tracing
from genomad_torch import native, trace
from genomad_torch.models import crf
from genomad_torch.ops import blosum, profiledb
from genomad_torch.ops import protein_search as tps
from genomad_torch.ops.profiledb import ALPHABET, N_AA, ProfileDB

torch.set_num_threads(2)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _seq(res):
    return "".join(ALPHABET[r] for r in res)


def _search_case(n_queries=80):
    """400 integral profiles (above the 256 under which the search skips
    its prefilter) and queries of which two in three are mutated
    consensus sequences of DB profiles."""
    db = ProfileDB.synthetic(seed=91, n_profiles=400, min_len=60, max_len=150, integral=True)
    rng = np.random.default_rng(6)
    names, seqs = [], []
    for qi in range(n_queries):
        if qi % 3 < 2:
            seq = db.consensus(int(rng.integers(0, 400))).copy()
            pos = rng.choice(len(seq), max(1, len(seq) // 8), replace=False)
            seq[pos] = rng.integers(0, N_AA, len(pos))
        else:
            seq = rng.integers(0, N_AA, int(rng.integers(60, 150)))
        names.append(f"g_{qi}")
        seqs.append(_seq(seq))
    return db, names, seqs


# ---------------------------------------------------------------------------
# When spans record
# ---------------------------------------------------------------------------


def test_without_a_profiler_nothing_is_recorded():
    trace.clear()
    assert trace.span("x") is trace.span("y") is trace._NO_SPAN
    with trace.span("x"), trace.timed("y", "trace_test_s"):
        pass
    db, names, seqs = _search_case()
    tps.search(names, seqs, db, device="cpu", batch_size=64)
    assert trace.spans() == []
    assert tps.STATS["trace_test_s"] > 0  # a timed block counts all the same


def test_a_worker_threads_span_records_with_its_job_and_parent():
    """The profiler runs on the main thread; a span opened on a worker
    thread records (the profiler's flag is read by every thread), nested in
    the submitting thread's span when submitted through ``trace.carry``,
    and a job of its own when not."""
    trace.clear()
    seen = {}

    def inner(tag):
        seen[tag] = threading.get_ident()
        with trace.span("inner", tag=tag):
            pass

    with _profiled():
        with trace.span("outer") as outer:
            with ThreadPoolExecutor(max_workers=1) as ex:
                ex.submit(trace.carry(inner), "carried").result()
                ex.submit(inner, "bare").result()
    got = {s.attrs.get("tag", s.name): s for s in trace.spans()}
    assert got["carried"].parent == outer.id and got["carried"].job == outer.job
    assert got["carried"].thread == seen["carried"] != outer.thread
    assert got["bare"].parent is None and got["bare"].job != outer.job
    assert got["outer"].parent is None and got["outer"].t0 <= got["carried"].t0 <= got["carried"].t1 <= got["outer"].t1


def test_spans_of_racing_threads_all_record_in_their_own_nests():
    """More threads than cores open nested spans at a short switch
    interval: every span is kept, each inner one in its own thread's
    outer span."""
    import sys

    trace.clear()
    n_threads, n_spans = 16, 500

    def work(i):
        with trace.span("outer", worker=i):
            for _ in range(n_spans):
                with trace.span("inner", worker=i):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recorded = trace.spans()
    outer = {s.attrs["worker"]: s for s in recorded if s.name == "outer"}
    inner = [s for s in recorded if s.name == "inner"]
    assert len(outer) == n_threads and len(inner) == n_threads * n_spans
    assert len({s.id for s in recorded}) == len(recorded)
    assert all(s.parent == outer[s.attrs["worker"]].id and s.thread == outer[s.attrs["worker"]].thread for s in inner)


def test_end_to_end_carries_its_job_to_the_annotate_worker(monkeypatch, tmp_path):
    """``run_end_to_end`` runs annotate on a worker thread beside the NN
    pass: both modules' spans are children of its ``end_to_end`` span, in
    one job, annotate's on the other thread."""
    from genomad_torch import cli
    from genomad_torch.modules import (
        aggregated_classification, annotate, find_proviruses, marker_classification, nn_classification, summary,
    )

    for module in (annotate, nn_classification, find_proviruses, marker_classification, aggregated_classification, summary):
        name = module.__name__.rsplit(".", 1)[1]
        monkeypatch.setattr(module, "main", trace.spanned(f"module.{name}")(lambda *a, **k: None))
    trace.clear()
    with _profiled():
        cli.run_end_to_end(tmp_path / "in.fna", tmp_path / "out", tmp_path / "db", device="cpu")
    recorded = trace.spans()
    (job,) = [s for s in recorded if s.name == "end_to_end"]
    modules = {s.name: s for s in recorded if s.name.startswith("module.")}
    assert {"module.annotate", "module.nn_classification", "module.find_proviruses", "module.summary"} <= set(modules)
    assert all(s.parent == job.id and s.job == job.job for s in modules.values())
    assert modules["module.annotate"].thread != job.thread == modules["module.nn_classification"].thread


# ---------------------------------------------------------------------------
# The counter registry
# ---------------------------------------------------------------------------


def test_stats_is_the_registry_and_every_key_still_counts():
    assert tps.STATS is trace.COUNTERS
    assert tps._count is trace.count
    tps.STATS.clear()
    db, names, seqs = _search_case()
    tps.search(names, seqs, db, device="cpu", batch_size=64)  # stages its buckets itself
    db2, _, _ = _search_case()
    tps._prestage(db2, [(torch.device("cpu"), (0, 1))], threading.Event())  # the prestage thread's body
    old = ("prefilter_s", "staging_s", "staging_wait_s", "prestage_s", "sw_forward_s", "sw_reverse_s", "finalize_s",
           "pairs_forward", "cells_forward", "pairs_reverse", "cells_reverse")
    assert all(tps.STATS[k] > 0 for k in old if k != "staging_wait_s"), dict(tps.STATS)
    assert "staging_wait_s" in tps.STATS
    assert tps.STATS["search.groups"] == 2
    assert tps.STATS["prefilter.queries"] == len(names)
    assert tps.STATS["prefilter.hits"] > tps.STATS["prefilter.candidates"] > 0


def _prefilter_inputs(db, seqs):
    residues = [profiledb.encode_protein(s) for s in seqs]
    return dict(index=db.kmer_index(1), residues_list=residues, db=db, min_ungapped_score=25.0,
                kmer_thr=blosum.kmer_score_threshold(4.2), bias_list=[blosum.comp_bias(r) for r in residues])


def test_native_prefilter_counts_the_same_work_at_any_thread_count(capfd):
    db, _, seqs = _search_case()
    inputs = _prefilter_inputs(db, seqs)
    counts, results = [], []
    for n_threads in (1, 4):
        before = dict(trace.COUNTERS)
        results.append(native.native_prefilter_batch(n_threads=n_threads, **inputs))
        counts.append({k: trace.COUNTERS[k] - before.get(k, 0.0) for k in native.WORK_KEYS})
    one, four = counts
    for key in ("prefilter.queries", "prefilter.hits", "prefilter.codes", "prefilter.candidates"):
        assert one[key] == four[key] > 0, key
    assert one["prefilter.queries"] == len(seqs)
    for c, n_threads in zip(counts, (1, 4)):
        assert 0 < c["prefilter.thread_s"] <= c["prefilter.slot_s"]
    assert all(np.array_equal(a, b) for a, b in zip(results[0][0], results[1][0]))
    assert capfd.readouterr().err == ""


def test_native_prefilter_given_no_queries_returns_empty_lists():
    db, _, _ = _search_case()
    before, uses = dict(trace.COUNTERS), native.native_prefilter_batch.uses
    assert native.native_prefilter_batch(**_prefilter_inputs(db, [])) == ([], [], 0)
    assert native.native_prefilter_batch.uses == uses
    assert {k: trace.COUNTERS.get(k, 0.0) for k in native.WORK_KEYS} == {k: before.get(k, 0.0) for k in native.WORK_KEYS}


# ---------------------------------------------------------------------------
# Spans at the work
# ---------------------------------------------------------------------------


def test_a_search_spans_its_stages_under_one_search_span():
    """80 queries in groups of 64: the streaming mode prefilters the next
    group on its pool thread while the search thread waits or aligns."""
    db, names, seqs = _search_case()
    trace.clear()
    with _profiled():
        tps.search(names, seqs, db, device="cpu", batch_size=64)
    recorded = trace.spans()
    by_id = {s.id: s for s in recorded}
    (search,) = [s for s in recorded if s.name == "search"]
    assert search.attrs == {"db_profiles": 400}
    assert all(s.job == search.job for s in recorded)

    def named(name):
        return [s for s in recorded if s.name == name]

    prefilters = named("search.prefilter")
    assert len(prefilters) == 2 and all(s.parent == search.id and s.thread != search.thread for s in prefilters)
    waits = named("search.prefilter_wait")
    assert len(waits) == 2 and all(s.parent == search.id and s.thread == search.thread for s in waits)
    aligns = named("search.align")
    assert {s.attrs["pass"] for s in aligns} == {"forward", "reverse"}
    assert all(s.parent == search.id for s in aligns)
    # the forward passes leave their stats on the device: only the reverse
    # pass copies its results back, and the survivors of the stop rule come
    # back inside the first finalize span
    for sync in named("search.align.sync"):
        launch = by_id[sync.parent]
        assert launch.name == "search.align.launch" and by_id[launch.parent].name == "search.align"
        assert by_id[launch.parent].attrs["pass"] == "reverse"
    assert len(named("search.align.sync")) == len([s for s in aligns if s.attrs["pass"] == "reverse"]) == 1
    finalizes = named("search.finalize")
    assert finalizes and all(s.parent == search.id for s in finalizes)
    (fetch,) = named("search.finalize.sync")
    assert fetch.parent == min(finalizes, key=lambda s: s.t0).id
    assert all(search.t0 <= s.t0 <= s.t1 <= search.t1 for s in recorded)


@pytest.mark.parametrize("lengths", [[5, 12, 3], [1], [40]])
def test_the_crf_counts_two_steps_a_position_of_its_batch(lengths):
    rng = np.random.default_rng(len(lengths))
    before = (trace.COUNTERS["crf.steps"], trace.COUNTERS["crf.contigs"])
    crf.score_provirus_genes_batch([rng.random(n) for n in lengths], [rng.random(n) for n in lengths], device="cpu")
    T = max(lengths)
    assert trace.COUNTERS["crf.steps"] - before[0] == 2 * (T - 1)
    assert trace.COUNTERS["crf.contigs"] - before[1] == len(lengths)


def test_md5_spans_and_counts_its_bytes(tmp_path):
    from genomad_torch import utils

    path = tmp_path / "x.fna"
    path.write_bytes(b">a\n" + b"ACGT" * 5000 + b"\n")
    before = trace.COUNTERS["md5.bytes"]
    trace.clear()
    with _profiled():
        digest = utils.get_md5(path)
    assert digest == utils.hashlib.md5(path.read_bytes()).hexdigest()
    assert trace.COUNTERS["md5.bytes"] - before == path.stat().st_size
    assert [s.name for s in trace.spans()] == ["md5"]


def test_encode_windows_counts_the_bases_it_puts_into_windows(tmp_path):
    """``nn.window_bp``: each kept window's bases before the N padding; a
    short last window and a window of more than 4,000 N after the first are
    not windows, and the contig's end runs of N are stripped."""
    from genomad_torch.ops import nn_pipeline

    rng = np.random.default_rng(3)
    acgt = lambda n: "".join("ACGT"[i] for i in rng.integers(0, 4, n))  # noqa: E731
    contigs = {
        "short": acgt(2_000),  # one window of 2,000
        "two": acgt(13_000),  # 6,000 + 6,000; the last 1,000 is under 2,500
        "n_rich": acgt(6_000) + "N" * 4_500 + acgt(1_500),  # the second window holds 4,500 N
        "n_ends": "N" * 40 + acgt(3_000) + "N" * 25,  # stripped to 3,000
    }
    path = tmp_path / "x.fna"
    path.write_text("".join(f">{k}\n{v}\n" for k, v in contigs.items()))
    before = trace.COUNTERS["nn.window_bp"]
    bases, names, ids = nn_pipeline.encode_windows(path)
    assert list(ids) == [0, 1, 1, 2, 3]
    assert trace.COUNTERS["nn.window_bp"] - before == 2_000 + 12_000 + 6_000 + 3_000 == int((bases != 4).sum())


# ---------------------------------------------------------------------------
# The benchmark's readers of the spans and counters
# ---------------------------------------------------------------------------


def _record(name, t0, t1, parent=None):
    span = trace.Span(name, {})
    span.id, span.parent, span.job, span.thread, span.t0, span.t1 = next(trace._SPAN_IDS), parent, 1, 0, t0, t1
    with trace._BUFFER_LOCK:
        trace._BUFFER.append(span)
    return span


def _hand_built_context():
    """A window [100, 110] s of 2 Mbp with one device operation at
    [100.25, 100.75] s, the port's spans and counters."""
    trace.clear()
    search = _record("search", 100.0, 109.0)
    _record("search.prefilter_wait", 95.0, 96.0, search.id)  # before the window: not read
    _record("search.prefilter_wait", 100.0, 100.5, search.id)
    _record("search.prefilter_wait", 101.0, 101.5, search.id)
    align = _record("search.align", 102.0, 104.0, search.id)
    launch = _record("search.align.launch", 102.5, 104.0, align.id)
    _record("search.align.sync", 103.0, 104.0, launch.id)
    _record("search.align.sync", 108.0, 108.5)  # in no search.align: not subtracted
    _record("search.finalize", 104.0, 104.25, search.id)
    _record("gene_calling.train", 107.0, 108.0)
    _record("fp.integrase_search", 105.0, 106.0)
    _record("fp.crf", 106.0, 106.5)
    _record("nn.cache_write", 100.0, 100.25)
    _record("nn.check_fasta", 100.25, 100.5)
    _record("md5", 100.5, 100.75)
    _record("nn.model_load", 101.0, 101.5)
    _record("nn.tables", 102.0, 102.25)
    counters = {"stats.prefilter.thread_s": 3.0, "stats.prefilter.slot_s": 4.0, "stats.prefilter.hits": 3e6,
                "stats.crf.steps": 1000.0}
    device = bench_tracing.DeviceTrace([("k", 100.25, 100.75)], 100.0, 110.0)
    return bench_run.Context(None, device, counters, 2.0, 0, 10.0, None)


READINGS = {
    "e2e.prefilter_wait_s_per_mbp": 0.5,
    "e2e.align_host_s_per_mbp": 0.5,
    "e2e.align_sync_s_per_mbp": 0.75,
    "e2e.finalize_s_per_mbp": 0.125,
    "e2e.prefilter_core_share": 75.0,
    "e2e.prefilter_ns_per_hit": 1000.0,
    "e2e.gene_training_s_per_mbp": 0.5,
    "e2e.integrase_search_s_per_mbp": 0.5,
    "e2e.crf_ms_per_step": 0.5,
    "e2e.idle_in_prefilter_wait_share": 7.5,
    "nn.cache_write_s_per_mbp": 0.125,
    "nn.input_check_s_per_mbp": 0.25,
    "nn.model_load_s_per_mbp": 0.25,
    "nn.tables_s_per_mbp": 0.125,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_a_reader_reads_the_ports_spans_and_counters(name):
    read = mf.metric_reader(name)
    assert read(_hand_built_context()) == pytest.approx(READINGS[name])
    trace.clear()
    empty = bench_run.Context(None, bench_tracing.DeviceTrace([], 100.0, 110.0), {}, 2.0, 0, 10.0, None)
    assert read(empty) is None


def test_the_readers_are_the_manifests_new_metrics():
    per_layer = {m["name"]: m for m in mf.load_manifest()["per_layer"]}
    assert set(READINGS) <= set(per_layer)
    for name in READINGS:
        cells = ["nn.metagenome"] if name.startswith("nn.") else ["e2e.metagenome", "e2e.isolate"]
        assert per_layer[name]["workloads"] == cells


# ---------------------------------------------------------------------------
# On the card: the spans and the device trace share one clock
# ---------------------------------------------------------------------------


@pytest.mark.chip
def test_a_span_holds_its_kernels_interval_on_the_trace_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from genomad_torch.ops import conv

    x = torch.randn(128, 6016, 128, device="cuda").to(torch.bfloat16)
    w = (torch.randn(6, 128, 128, device="cuda") * 0.05).to(torch.bfloat16)
    b = torch.zeros(128, device="cuda", dtype=torch.bfloat16)
    conv.causal_conv(x, w, b)  # builds and warms the kernel
    torch.cuda.synchronize()
    trace.clear()
    with bench_tracing.Profiler() as prof:
        with trace.span("k4") as span:
            conv.causal_conv(x, w, b)
            torch.cuda.synchronize()
    ops = [op for op in prof.read(span.t0 - 1.0, span.t1 + 1.0).ops if "causal_conv" in op[0]]
    assert len(ops) == 1, ops
    _, start, end = ops[0]
    assert span.t0 - 5e-4 <= start < end <= span.t1 + 5e-4, (span.t0, start, end, span.t1)
