"""A later cell, configuration and per-layer metric are files found by
name: adding them edits no file that is there."""

import hashlib
import json
import os
import shutil

import pytest

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def digest(tree):
    out = {}
    for dirpath, _, files in os.walk(tree):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, tree)] = hashlib.sha1(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bj_path = tmp_path / "BENCHMARK.json"
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bj_path)
    before = digest(bench)
    # the later PR's files
    (bench / "traffic" / "fleet48.json").write_text(json.dumps(dict(
        streams=48, chunk=8, ba_every=16, loop_period=360,
        landmarks_per_frame=170, trace_steps=2, check_streams=4)))
    (bench / "metrics" / "frames_per_launch.py").write_text(
        "def read(ctx):\n    return ctx['frames'] / 2.0\n")
    bj = json.loads(bj_path.read_text())
    bj["workloads"].append(dict(name="relaxed.fleet48",
                                config="sp-lg-relaxed", traffic="fleet48",
                                chips=1, why="a later cell"))
    bj["per_layer"].append(dict(name="frames_per_launch", unit="1",
                                better="higher", source="device_trace",
                                layer="dispatch", moves="fps",
                                workloads=["relaxed.fleet48"]))
    bj_path.write_text(json.dumps(bj))
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before

    cell = harness.load_cell("relaxed.fleet48", str(bj_path), str(bench))
    assert cell["traffic"]["streams"] == 48
    assert cell["config"]["name"] == "sp-lg-relaxed"
    names = [m["name"] for m in cell["per_layer"]]
    assert "frames_per_launch" in names and "mfu" in names
    read = harness.metric_reader("frames_per_launch", str(bench))
    assert read(dict(frames=10)) == 5.0
    # the metric of a cell that does not list it stays out
    other = harness.load_cell("strict.fleet64", str(bj_path), str(bench))
    assert "frames_per_launch" not in [m["name"] for m in other["per_layer"]]


def test_every_metric_and_cell_of_the_benchmark_has_its_files():
    bj = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bj["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        harness.slam_config(cell["config"])
    for m in bj["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    for c in bj["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []


def test_an_unknown_cell_is_refused():
    with pytest.raises(harness.SetupError):
        harness.load_cell("no.such.cell")
