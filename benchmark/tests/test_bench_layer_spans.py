"""The per-layer metrics of the prologue and the tracking loop, on
synthetic records through the trace reader: they read the program's
`prologue.*` and `track.*` ranges, and the benchmark's `bench.chunk`
range keeps the kernels issued outside them."""

import pytest

from benchmark import harness, trace
from benchmark.trace import Record

FRAMES = 4


def rec(name, a, b, dev=False, ann=False):
    return Record(name, a, b, dev, ann)


def chunk_step():
    """One chunk and one BA pass as the profiler sees them: host ranges,
    device spans and kernels. The program's `chunk`, `prologue`, `track`
    and `backend.ba` spans open no range, so the kernels issued between
    the stage ranges are `bench.chunk`'s. Idle gaps: 190-195 in `extract`,
    200-210 in `prologue.match`, 290-320 in `prologue.essential`, 700-720
    in `track.pose_lm`, 930-1100 in `track.host_read`, 1500-1550 in
    `bench.ba`, and 440-650, 780-920 and 1200-1360 in `bench.chunk`."""
    return [
        rec("bench.chunk", 0, 1350, ann=True),
        rec("extract", 2, 200, ann=True),
        rec("prologue.match", 200, 300, ann=True),
        rec("prologue.essential", 300, 450, ann=True),
        rec("track.pose_lm", 600, 800, ann=True),
        rec("track.host_read", 900, 1050, ann=True),
        rec("bench.ba", 1350, 1700, ann=True),
        rec("cnn", 10, 190, dev=True),
        rec("cat", 195, 200, dev=True),
        rec("lg", 210, 290, dev=True),
        rec("ransac", 320, 440, dev=True),
        rec("lm", 650, 700, dev=True),
        rec("lm", 720, 780, dev=True),
        rec("copy", 920, 930, dev=True),
        rec("gemv", 1100, 1200, dev=True),
        rec("ba", 1360, 1500, dev=True),
        rec("ba", 1550, 1650, dev=True),
        rec("extract", 10, 190, dev=True, ann=True),
        rec("bench.chunk", 195, 1200, dev=True, ann=True),
        rec("prologue.match", 210, 290, dev=True, ann=True),
        rec("prologue.essential", 320, 440, dev=True, ann=True),
        rec("track.pose_lm", 650, 780, dev=True, ann=True),
        rec("track.host_read", 920, 930, dev=True, ann=True),
        rec("bench.ba", 1360, 1650, dev=True, ann=True),
    ]


def ctx(records):
    return dict(summary=trace.summarize(records), frames=FRAMES)


def read(name, c):
    return harness.metric_reader(name)(c)


def test_the_layer_metrics_sum_their_stage_ranges():
    c = ctx(chunk_step())
    # LightGlue and the RANSAC, both inside the prologue
    assert read("prologue_ms_per_frame", c) == pytest.approx(
        1e3 * 200e-9 / FRAMES)
    assert read("track_ms_per_frame", c) == pytest.approx(
        1e3 * 140e-9 / FRAMES)
    # the benchmark's own ranges keep their readings
    assert read("chunk_ms_per_frame", c) == pytest.approx(
        1e3 * 1005e-9 / FRAMES)
    assert read("ba_ms_per_frame", c) == pytest.approx(1e3 * 290e-9 / FRAMES)


def test_track_idle_counts_every_track_range_and_nothing_else():
    c = ctx(chunk_step())
    assert c["summary"].gaps_s == pytest.approx({
        "extract": 5e-9, "prologue.match": 10e-9,
        "prologue.essential": 30e-9, "track.pose_lm": 20e-9,
        "track.host_read": 170e-9, "bench.ba": 50e-9,
        "bench.chunk": 510e-9})
    assert read("track_idle_ms_per_frame", c) == pytest.approx(
        1e3 * 190e-9 / FRAMES)


def test_a_trace_without_the_stage_ranges_reads_nothing():
    """No `prologue.*` or `track.*` range: no reader raises, none reads."""
    bare = [r for r in chunk_step()
            if not r.name.startswith(("prologue.", "track."))]
    c = ctx(bare)
    assert c["summary"].gaps_s.get("bench.chunk", 0) > 0
    for name in ("prologue_ms_per_frame", "track_ms_per_frame",
                 "track_idle_ms_per_frame"):
        assert read(name, c) is None
        assert read(name, dict(summary=None, frames=FRAMES)) is None
