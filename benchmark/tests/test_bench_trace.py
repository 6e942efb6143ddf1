"""The trace reader on synthetic records."""

import pytest

from benchmark import trace
from benchmark.trace import Record


def rec(name, a, b, dev=False, ann=False):
    return Record(name, a, b, dev, ann)


def profile():
    return [
        rec("bench.chunk", 0, 1000, ann=True),
        rec("extract", 0, 300, ann=True),
        rec("cudaLaunchKernel", 10, 12),
        rec("cudaLaunchKernel", 20, 22),
        rec("cuLaunchKernelEx", 30, 32),
        rec("aten::mm", 5, 40),
        rec("attention_kernel<128>", 100, 200, dev=True),
        rec("attention_kernel<128>", 150, 250, dev=True),   # overlaps
        rec("assign_pass<256, false>", 600, 700, dev=True),
        rec("extract", 100, 250, dev=True, ann=True),
        rec("bench.ba", 1000, 2000, ann=True),
        rec("ba_kernel", 1500, 1600, dev=True),
        rec("bench.ba", 1500, 1600, dev=True, ann=True),
    ]


def test_busy_launches_spans_and_kernels():
    s = trace.summarize(profile())
    assert s.launches == 3
    assert s.busy_s == pytest.approx((150 + 100 + 100) / 1e9)
    assert s.span_s == pytest.approx({"extract": 150e-9, "bench.ba": 100e-9})
    t, n = trace.device_time(s, ("attention_kernel",))
    assert (t, n) == (pytest.approx(200e-9), 2)
    assert trace.device_time(s, ("nms_kernel",)) == (0, 0)


def test_idle_gaps_named_by_the_innermost_host_range():
    s = trace.summarize(profile())
    # 250-600 (midpoint 425: inside bench.chunk, extract ended at 300)
    # and 700-1500 (midpoint 1100: inside bench.ba)
    assert s.gaps_s == pytest.approx({"bench.chunk": 350e-9,
                                      "bench.ba": 800e-9})
    assert trace.top(s.gaps_s, 1) == [["bench.ba", pytest.approx(800e-9)]]


def test_gap_outside_every_range():
    s = trace.summarize([rec("k", 0, 10, dev=True),
                         rec("k", 30, 40, dev=True)])
    assert s.gaps_s == pytest.approx({"(outside)": 20e-9})


def test_a_trace_without_device_records_fails():
    with pytest.raises(trace.TraceError):
        trace.summarize([rec("bench.chunk", 0, 10, ann=True),
                         rec("cudaLaunchKernel", 1, 2)])
