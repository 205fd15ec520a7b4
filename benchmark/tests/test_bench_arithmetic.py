"""The FLOP, byte and roofline arithmetic on known shapes."""

import pytest

from benchmark import manifest as mf
from benchmark import peaks
from benchmark.reference import igloo

W = igloo.widths(mf.config("genomad-nn"))


def test_igloo_flops_per_window():
    conv = 2 * 5997 * 6 * 128 * 128
    igloo = 2 * 2100 * 4 * 128 + 2 * 5992 * 128 * 128 + 2 * 2100 * 749 + 2 * 749 * 128
    dense = 2 * (256 * 512 + 512 * 512 + 512 * 3)
    assert peaks.igloo_forward_flops(W, 1) == 5997 * 6 * 128 + 2 * conv + 2 * igloo + dense
    assert peaks.igloo_forward_flops(W, 128) == pytest.approx(0.354e12, rel=0.01)


def test_k4_bound_is_its_operations_at_batch_128():
    # 151 GFLOP a launch at 989 TFLOP/s: PERF.md's K4 bound (0.1531 ms at 6,016 positions)
    t = peaks.k4_least_seconds(W, 128, 1)
    assert t == pytest.approx(2 * 6 * 128 * 128 * 5997 * 128 / 989e12)
    assert t * 1e3 == pytest.approx(0.1531 * 5997 / 6016, rel=2e-3)


def test_k2_bound_is_its_bytes_at_batch_128():
    t = peaks.k2_least_seconds(W, 128, 1)
    bytes_moved = 128 * (5997 * 128 * 2 + 2100 * 4 + 749 * 128 * 2) + 2100 * 4 * (4 + 256) + 128 * 128 * 2
    assert t == pytest.approx(bytes_moved / 3.35e12)


def test_k1_bound_and_mfu():
    assert peaks.k1_least_seconds(33.5e12 / 12) == pytest.approx(1.0)
    assert peaks.mfu_percent(989e12, 2.0) == pytest.approx(50.0)
    assert peaks.mfu_percent(0, 1.0) is None
    assert peaks.mfu_percent(989e12, 1.0, lane_ops=33.5e12) == pytest.approx(200.0)


def test_the_counts_follow_the_configurations_widths():
    """A configuration at other widths is counted at its own."""
    import dataclasses

    half = dataclasses.replace(W, channels=64)
    assert peaks.k4_least_seconds(half, 128, 1) < peaks.k4_least_seconds(W, 128, 1) / 2
    assert peaks.igloo_forward_flops(half, 1) < peaks.igloo_forward_flops(W, 1)
    assert igloo.widths(mf.config("genomad-e2e")) == W
