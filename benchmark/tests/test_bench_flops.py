"""The benchmark's counts of operations and bytes."""

import json
import os

import pytest

from benchmark import flops

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shape(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return flops.cell_shape(json.load(f))


def test_frame_flops_of_the_two_configurations():
    assert flops.frame_flops(shape("sp-lg-strict")) == 794_764_953_600
    assert flops.frame_flops(shape("sp-lg-relaxed")) == 608_469_174_272


def test_attention_calls_add_up_to_lightglues_attention_term():
    """lightglue_flops counts 4 d (n + m)^2 a layer for QK^T and PV."""
    for name in ("sp-lg-strict", "sp-lg-relaxed"):
        sh = shape(name)
        d, L = sh["lightglue"]["dim"], sh["lightglue"]["layers"]
        n, m = sh["keypoints"], sh["reobs_points"]
        want = L * 4 * d * ((2 * n) ** 2 + sh["reobs_passes"] * (n + m) ** 2)
        calls = flops.attention_calls(sh)
        assert sum(f for f, _ in calls) == want
        assert len(calls) == L * 4 * (1 + sh["reobs_passes"])


def test_assignment_calls_and_bounds():
    sh = shape("sp-lg-strict")
    calls = flops.assignment_calls(sh)
    assert [f for f, _ in calls] == [2 * 2048 * 2048 * 256] * 3
    f, b = calls[0]
    # ops-bound at these shapes: 2.1 GFLOP against ~2.2 MB
    assert flops.bound_s(f, b) == pytest.approx(f / flops.PEAK_BF16_FLOPS)
    assert flops.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
