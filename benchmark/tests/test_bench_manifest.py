"""BENCHMARK.json against the contract's limits, and the files it names."""

import json
import re

import pytest

from benchmark import manifest as mf

M = mf.load_manifest()
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((mf.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w) for w in M["command"])
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    cells = len(M["workloads"])
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(M["configs"]) <= 24


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in M[kind]]
    assert len(names) == len(set(names))
    assert all(mf.NAME.match(n) for n in names)


def test_metrics():
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e and len(M["end_to_end"]) <= 16
    for m in M["end_to_end"] + M["per_layer"]:
        assert mf.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in M["workloads"]}
    layers = {m["layer"] for m in M["per_layer"]}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        for w in m.get("workloads", cells):  # the cell reports what the metric moves
            assert w in [c for c in cells if any(c in x.get("workloads", cells) for x in M["end_to_end"] if x["name"] == m["moves"])]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(layers) < len(M["per_layer"])


def test_every_cell_reports_enough():
    for w in M["workloads"]:
        e2e = mf.metrics_of_cell(M, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert mf.metrics_of_cell(M, w["name"], "per_layer")
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["name"] in used and c["file"].startswith(tuple(p + "/" for p in M["paths"]))
        assert c["source"].startswith("https://") and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(mf.NAME.match(k) for k in c["reduced"])
        data = json.loads((mf.REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert all(k in data for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or k in ("channels", "dense", "patches", "patch_size") for k in c["reduced"])
