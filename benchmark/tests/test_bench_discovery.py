"""Configurations, traffic mixes, their recipes and metrics are found by name."""

import pytest

from benchmark import manifest as mf
from benchmark import run, tracing
from benchmark.reference import igloo

M = mf.load_manifest()
WIDTHS = igloo.widths(mf.config("genomad-nn"))


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found(w):
    config = mf.config(w["config"])
    mix = mf.traffic(w["traffic"])
    assert config["name"] == w["config"]
    assert (mf.ROOT / "entries" / f"{config['entry']}.py").exists()
    assert (mf.ROOT / "recipes" / f"{mix['content']}.py").exists() and mix["pool_jobs"] >= 1


@pytest.mark.parametrize("m", M["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_load_and_read_nothing_from_nothing(m):
    read = mf.metric_reader(m["name"])
    ctx = run.Context(tracing.Spans(), tracing.DeviceTrace([], 0.0, 1.0), {}, 0.0, 0, 1.0, WIDTHS)
    assert read(ctx) is None


@pytest.mark.parametrize("m", [m for m in M["end_to_end"] if m["name"] != "setup_s"], ids=lambda m: m["name"])
def test_end_to_end_readers_read_the_rate(m):
    ctx = run.Context(None, None, {}, 3.0, 0, 1.5, WIDTHS)
    assert mf.metric_reader(m["name"])(ctx) == pytest.approx(2.0)


def test_metric_files_are_exactly_the_manifest_metrics():
    files = {p.stem for p in (mf.ROOT / "metrics").glob("*.py")}
    assert files == {m["name"] for m in M["per_layer"] + M["end_to_end"]} - {"setup_s"}


def test_a_reader_reads_its_span_and_trace():
    spans = tracing.Spans()
    spans.spans = [
        {"name": "nn_module", "t0": 0.0, "t1": 1.0, "job": 0},
        {"name": "encode", "t0": 0.0, "t1": 0.25, "job": 0},
        {"name": "inference", "t0": 0.25, "t1": 0.75, "job": 0},
    ]
    dev = tracing.DeviceTrace([("causal_conv_bf16", 0.3, 0.4), ("x", 0.35, 0.5)], 0.0, 1.0)
    ctx = run.Context(spans, dev, {"k4_launches": 10}, 2.0, 1280, 1.0, WIDTHS)
    assert mf.metric_reader("nn.module_rest_s_per_mbp")(ctx) == pytest.approx(0.125)
    assert mf.metric_reader("nn.inference_s_per_mbp")(ctx) == pytest.approx(0.25)
    assert mf.metric_reader("nn.device_idle_share")(ctx) == pytest.approx(80.0)
    assert 0 < mf.metric_reader("nn.k4_roofline")(ctx) < 100
    assert dev.idle_by_span(spans.spans)[0][0] in ("encode", "inference", "nn_module")


def test_a_mix_sets_its_cells_limits(tiny_run, monkeypatch):
    """e2e.isolate's mix lowers nn_score_gap's limit for that cell only."""

    assert mf.traffic("isolate-prophages")["limits"]["nn_score_gap"] < mf.config("genomad-e2e")["limits"]["nn_score_gap"]
    real = mf.traffic

    def with_limit(name):
        return {**real(name), "limits": {"nn_score_gap": 1e-9}} if name == "metagenome-random" else real(name)

    monkeypatch.setattr(mf, "traffic", with_limit)
    result = tiny_run("nn.metagenome")
    assert result["checks"]["nn_score_gap"]["limit"] == 1e-9 and not result["correct"]
