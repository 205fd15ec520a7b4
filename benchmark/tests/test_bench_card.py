"""On a card: one short run of a cell through the command, as the driver
runs it. Skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmark import manifest as mf


@pytest.mark.chip
def test_a_short_run_is_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "nn.metagenome", "--seed", "2147483901",
         "--seconds", "5", "--trace", "0"],
        cwd=mf.REPO, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
