"""The reader of ``e2e.prefilter_card_s_per_mbp``: the device seconds of the
card prefilter's kernels (named with ``prefilter_``) per Mbp, and nothing
where no such kernel ran."""

import pytest

from benchmark import manifest as mf
from benchmark import run, tracing


def _ctx(device_ops, mbp=2.0):
    return run.Context(None, tracing.DeviceTrace(list(device_ops), 0.0, 10.0), {}, mbp, 0, 10.0, None)


def test_the_card_prefilter_reader():
    read = mf.metric_reader("e2e.prefilter_card_s_per_mbp")
    k1 = ("void (anonymous namespace)::sw_chunk_kernel<__nv_bfloat16, 12>(...)", 1.0, 4.0)
    ops = [("void (anonymous namespace)::prefilter_hits_kernel(int, ...)", 1.0, 1.5),
           ("void (anonymous namespace)::prefilter_bucket_kernel<signed char>(...)", 2.0, 2.25), k1]
    assert read(_ctx(ops)) == pytest.approx(0.75 / 2.0)
    # the host prefilter (the parent's program): no such kernel, nothing to read
    assert read(_ctx([k1])) is None and read(_ctx([])) is None
