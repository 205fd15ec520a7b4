"""``BENCHMARK.json`` and the files it names, found by name:

- a configuration ``C``: ``benchmark/configs/C.json``;
- a traffic mix ``T``: ``benchmark/traffic/T.json`` (data for
  ``benchmark/generator.py``);
- a metric ``M`` other than ``setup_s``, per-layer or end-to-end:
  ``benchmark/metrics/M.py``, a reader with ``read(ctx) -> float | None``
  (``ctx``: ``benchmark.run.Context``).
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(path: Path | None = None) -> dict:
    return json.loads((path or REPO / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def metric_reader(name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of_cell(manifest: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    whose ``workloads`` list it, or that have none."""
    return [m for m in manifest[kind] if cell_name in m.get("workloads", [cell_name])]
