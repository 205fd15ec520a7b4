"""The benchmark's own tests, run on the CPU: ``python -m pytest benchmark/tests -q``.
Tests marked ``chip`` need a CUDA card and skip without one."""

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# A cell at a size the CPU holds: a 400-profile DB (above the 256 under
# which the port aligns every pair without its prefilter), jobs of 30-40
# kbp. The gene caller trains on each sample, and on so few genes it
# misses more starts (5-25% against 1-4% at 0.5 Mbp): the gene checks'
# limits are wider here.
TINY_LIMITS = {**json.loads((Path(__file__).resolve().parents[1] / "configs" / "genomad-e2e.json").read_text())["limits"],
               "genes_missed_pct": 35, "calls_unwritten_pct": 35}
TINY_DB = {"profiles": 400, "seed": 1, "min_len": 60, "max_len": 400, "integrase_profiles": 16,
           "integrase_seed": 99, "integrase_len": [60, 90]}
TINY = {
    "e2e.metagenome": {"config": {"sample_mbp": 0.03, "check_jobs_within": 2, "db": TINY_DB, "limits": TINY_LIMITS},
                       "traffic": {"pool_jobs": 2, "warm_up_mbp": 0.02}},
    "e2e.isolate": {"config": {"sample_mbp": 0.04, "check_jobs_within": 2, "db": TINY_DB, "limits": TINY_LIMITS},
                    "traffic": {"pool_jobs": 2, "warm_up_mbp": 0.02, "plasmid_bp": 6000,
                                "prophage": {"count": 1, "bp": 14000, "virus_marker_share": 0.6}}},
    "nn.metagenome": {"config": {"sample_mbp": 0.04, "check_jobs_within": 2},
                      "traffic": {"pool_jobs": 2, "warm_up_mbp": 0.01}},
}


@pytest.fixture
def tiny_run(tmp_path):
    """run_cell at TINY sizes on the CPU, one job in the window."""
    import torch

    from benchmark import run

    torch.set_num_threads(4)

    runs = iter(range(1000))

    def go(cell, seed=5, trace=False):
        return run.run_cell(cell, seed, 0.01, trace, device="cpu", overrides=TINY[cell], workdir=tmp_path / f"run{next(runs)}")

    return go
