"""Bounds on the port's committed evaluation reports, each written on the
card by its script; a test skips while its report is absent.

  * FLAGSHIP_EVAL_TORCH.json (scripts/eval_flagship_torch.py): the bounds
    of tests/test_flagship_e2e.py::test_flagship_eval_report_bounds, at
    least 100 frames, from an NVIDIA card;
  * FLAGSHIP_EVAL_HARD_TORCH.json (the same script, --domain hard): the
    bounds of tests/test_flagship_e2e.py::
    test_flagship_hard_eval_report_bounds, from an NVIDIA card;
  * LOOPCLOSE_EVAL_TORCH.json (scripts/eval_loopclose_torch.py): the
    bounds of tests/test_loopclose.py::test_loopclose_eval_bounds;
  * MS_ECON_TORCH.json (scripts/profile_multistream_torch.py): the bound
    of tests/test_multichip_scaling.py::test_ms_econ_table_bounds (the
    time-multiplexed aggregate at 2, 4, 8 and 16 streams >= 0.85 x the
    single stream), and the batched aggregate at 4 streams >= the
    time-multiplexed one, from an NVIDIA card;
  * TRAIN_TINY_TORCH.json (scripts/train_frontend_torch.py --preset tiny
    --track-report): the weights the port trained from scratch hold the
    bounds of tests/test_learned_e2e.py::test_learned_pipeline_tracks on
    its held-out scene, every trainer ran and lowered its loss, and the
    card's name and power limit stand in the report.
"""

import json
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _report(name, script):
    path = os.path.join(ROOT, name)
    if not os.path.exists(path):
        pytest.skip(f"no committed {name} (run scripts/{script} on the "
                    f"card)")
    with open(path) as f:
        return json.load(f)


def test_flagship_eval_torch_report_bounds():
    rep = _report("FLAGSHIP_EVAL_TORCH.json", "eval_flagship_torch.py")
    assert rep["device"].startswith("NVIDIA"), rep["device"]
    assert rep["num_frames"] >= 100, rep
    assert rep["ate_pct_of_trajectory"] <= 0.5, rep
    assert rep["num_keyframes"] >= 0.97 * rep["num_frames"], rep
    assert rep["mean_matches"] > 300, rep
    assert rep["num_ba_runs"] >= 5, rep


def test_flagship_hard_eval_torch_report_bounds():
    rep = _report("FLAGSHIP_EVAL_HARD_TORCH.json", "eval_flagship_torch.py "
                  "--domain hard")
    assert rep["device"].startswith("NVIDIA"), rep["device"]
    assert "domain=hard" in rep["config"], rep["config"]
    assert rep["num_frames"] >= 100, rep
    assert rep["ate_pct_of_trajectory"] <= 1.0, rep
    assert rep["num_keyframes"] >= 0.9 * rep["num_frames"], rep
    assert rep["mean_matches"] > 300, rep


def test_loopclose_eval_torch_report_bounds():
    rep = _report("LOOPCLOSE_EVAL_TORCH.json", "eval_loopclose_torch.py")
    assert rep["device"].startswith("NVIDIA"), rep["device"]
    assert rep["loop_off"]["frames"] >= 300, rep
    assert rep["loop_on"]["loop_closures"] >= 1, rep
    assert rep["loop_off"]["loop_closures"] == 0, rep
    assert rep["loop_on"]["ate_rmse_m"] < rep["loop_off"]["ate_rmse_m"], rep


def test_ms_econ_torch_report_bounds():
    rep = _report("MS_ECON_TORCH.json", "profile_multistream_torch.py")
    assert rep["card"].startswith("NVIDIA"), rep["card"]
    single = rep["single_stream_fps"]
    agg = rep["aggregate_fps_by_streams"]
    assert set(agg) == {"2", "4", "8", "16"}, rep
    for s, v in agg.items():
        assert v >= 0.85 * single, (s, v, single)
    batched = rep["batched_aggregate_fps_by_streams"]
    assert set(batched) == {"1", "2", "4", "8", "16"}, rep
    assert batched["4"] >= agg["4"], (batched, agg)


def test_train_tiny_torch_report_bounds():
    rep = _report("TRAIN_TINY_TORCH.json", "train_frontend_torch.py "
                  "--preset tiny --track-report TRAIN_TINY_TORCH.json")
    # nvidia-smi's "name, power.limit": e.g. "NVIDIA H100 ..., 700.00 W"
    name, power = rep["device"].rsplit(", ", 1)
    assert name.startswith("NVIDIA"), rep["device"]
    assert power.endswith(" W") and float(power[:-2]) > 0, rep["device"]
    assert rep["preset"] == "tiny", rep
    assert set(rep["trainers"]) == {"superpoint", "subpix", "pair_subpix",
                                    "lightglue"}, rep
    for name, t in rep["trainers"].items():
        assert t["steps"] > 0 and t["wall_s"] > 0 and t["step_ms"] > 0, name
        assert t["last_loss"] < t["first_loss"], (name, t)
    res = rep["trained"]
    assert res["ate_m"] < 1.0, res
    assert res["num_keyframes"] == 32, res
    assert res["mean_matches"] > 50, res
    assert res["num_ba_runs"] >= 5, res
    assert rep["committed"]["num_keyframes"] == 32, rep
