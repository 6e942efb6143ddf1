"""The port's command-line entry point on a KITTI-layout directory, on the
CPU.

The dataset is the one of tests/test_cli_e2e.py (a 160x240 rendered scene,
seed 23, 20 frames, written by the port's `write_kitti_sequence`); the
chunked runs take that test's arguments (tiny preset, chunk 4, BA every 4:
a bootstrap, four chunks and a tail of 2 frames padded to 4) and its
bounds, and the JAX chunked report's keys are read from its source. The
per-frame routes (oracle, Harris, the learned extractor at batch 1) run
in both CLIs on the same arguments and the same RANSAC draws, the JAX CLI
with its PIL frame loader (its native one is a build of its own).
"""

import argparse
import ast
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from gl_slam_tpu_torch import cli
from gl_slam_tpu_torch.io import synthetic
from gl_slam_tpu_torch.io.kitti import KittiSequence, write_kitti_sequence
from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints")
ARTIFACTS = ("trajectory.txt", "map.json", "trajectory.png")


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    scene = synthetic.make_scene(num_landmarks=700, num_frames=20,
                                 height=160, width=240, desc_dim=64,
                                 seed=23)
    return write_kitti_sequence(root, scene, num_frames=20,
                                max_keypoints=96)


def _argv(kitti_dir, out, *extra):
    return ["run", "--dataset", kitti_dir, "--sequence", "00",
            "--frontend", "superpoint", "--preset", "tiny",
            "--weights", CKPT, "--out", out,
            "--first-frame", "0", "--last-frame", "19",
            "--height", "160", "--width", "240", "--kpts", "96",
            "--chunk", "4", "--ba-every", "4", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def cli_run(kitti_dir, tmp_path_factory):
    """run(subpix, warmup=True) -> (report, out dir): one CLI run per
    argument pair for the whole module."""
    runs = {}

    def run(subpix, warmup=True):
        if (subpix, warmup) not in runs:
            out = str(tmp_path_factory.mktemp("out"))
            extra = () if subpix is None else ("--subpix", subpix)
            stdout = io.StringIO()
            with pytest.MonkeyPatch.context() as mp, \
                    contextlib.redirect_stdout(stdout):
                if not warmup:
                    mp.setattr(ChunkedPipeline, "warmup",
                               lambda self, images: None)
                assert cli.main(_argv(kitti_dir, out, *extra)) == 0
            runs[subpix, warmup] = (json.loads(stdout.getvalue()), out)
        return runs[subpix, warmup]
    return run


@pytest.mark.parametrize("subpix", [None, "single"])
def test_cli_chunked_route_on_kitti_layout(cli_run, subpix):
    """The bounds of tests/test_cli_e2e.py's chunked-route test, from the
    default sub-pixel mode (pair) and the single-view head."""
    report, out = cli_run(subpix)
    assert report["frontend"] == "superpoint-chunked"
    assert report["subpix"] == (subpix or "pair")
    assert report["frames_tracked"] >= 14, report
    assert report["ate_rmse_m"] < 2.0, report
    assert report["ba_runs"] >= 2, report
    for f in ARTIFACTS:
        assert os.path.exists(os.path.join(out, f)), f
    # every real frame fed once; the 2 padded frames of the tail rejected
    assert report["frames_fed"] == 20 and report["frames_rejected"] >= 2
    traj = np.loadtxt(os.path.join(out, "trajectory.txt"))
    assert traj.shape == (report["frames_tracked"], 12)
    with open(os.path.join(out, "map.json")) as f:
        snap = json.load(f)
    assert len(snap["keyframe_centers"]) == report["frames_tracked"]
    assert len(snap["points"]) > 50


def _jax_chunked_report_keys():
    """The keys of the report that gl_slam_tpu/cli.py's `_run_chunked`
    prints, read from its source."""
    path = os.path.join(ROOT, "gl_slam_tpu", "cli.py")
    tree = ast.parse(open(path).read(), path)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_run_chunked")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id == "report" \
                    and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            elif isinstance(tgt, ast.Subscript) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == "report":
                keys.add(tgt.slice.value)
    return keys


def test_cli_report_has_the_keys_of_jax(cli_run):
    """The JAX report's keys, and `stages`: the host time of each
    top-level span, in the per-frame route's format."""
    report, _ = cli_run(None)
    keys = _jax_chunked_report_keys()
    assert "ate_rmse_m" in keys and "frames_rejected" in keys
    assert set(report) == keys | {"stages"}
    stages = report["stages"]
    assert set(stages) == {"backend.ba", "backend.recycle", "bootstrap",
                           "chunk", "warmup"}
    # frames 2-19 in chunks of 4: four chunks and the tail, a BA pass after
    # each (the warm-up's own pass is inside `warmup`)
    assert stages["chunk"]["count"] == stages["backend.ba"]["count"] == 5
    assert stages["bootstrap"]["count"] == stages["warmup"]["count"] == 1
    for v in stages.values():
        assert set(v) == {"total_s", "mean_ms", "count"}


def test_cli_warmup_changes_nothing(cli_run):
    """The warm-up chunk runs on a throwaway state with throwaway draws:
    the run with it gives the trajectory and map of the run without it, bit
    for bit."""
    _, out = cli_run(None)
    _, out_cold = cli_run(None, warmup=False)
    for f in ("trajectory.txt", "map.json"):
        with open(os.path.join(out, f), "rb") as a, \
                open(os.path.join(out_cold, f), "rb") as b:
            assert a.read() == b.read(), f


# The per-frame route (oracle on the synthetic sequence at the layout's
# size; Harris and the learned extractor at batch 1 on KITTI layouts): 12
# frames, so that one window BA pass runs (BA trigger 7). Harris runs on a
# denser layout of the same size (`harris_dir`: 300 blobs a frame, 256
# corners): on the 96 blobs of `kitti_dir` its integer corners leave 4 of
# 34 matches as essential inliers at the bootstrap, a degenerate solve
# whose pose moves by millimetres with the last bit of its inputs, and 4 of
# the 12 frames are tracked, in JAX as in the port.
PER_FRAME = {
    "oracle": ("--dataset", "synthetic", "--frontend", "oracle",
               "--landmarks", "1500"),
    "harris": ("--frontend", "harris", "--kpts", "256"),
    "per-frame": ("--frontend", "superpoint", "--per-frame",
                  "--match-thr", "0.4"),
}


@pytest.fixture(scope="module")
def harris_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_dense"))
    scene = synthetic.make_scene(num_landmarks=2000, num_frames=12,
                                 height=160, width=240, desc_dim=64,
                                 seed=23)
    return write_kitti_sequence(root, scene, num_frames=12,
                                max_keypoints=300)


def _per_frame_argv(kitti_dir, out, route):
    return ["run", "--dataset", kitti_dir, "--sequence", "00",
            "--preset", "tiny", "--weights", CKPT, "--out", out,
            "--first-frame", "0", "--last-frame", "11", "--height", "160",
            "--width", "240", "--kpts", "96", "--hypotheses", "128",
            *PER_FRAME[route]]


def _jax_draws(hypotheses):
    """The JAX pipeline's RANSAC draws from PRNGKey(0), without end:
    bootstrap `split(key)`, then `split(key, 3)` per tracked frame."""
    import jax
    key, k = jax.random.split(jax.random.PRNGKey(0))
    while True:
        yield np.asarray(jax.random.uniform(k, (hypotheses, 8)))
        key, k, _ = jax.random.split(key, 3)


@pytest.fixture(scope="module")
def per_frame_run(kitti_dir, harris_dir, tmp_path_factory):
    """run(route) -> (port report, port out dir, JAX report): one run of
    each CLI per route, the port's on the CPU with the JAX draws, both
    CLIs with their PIL frame loader (not the native one), so that both
    read the same pixels; the JAX CLI loads its learned weights through
    jax_weights.py (the same arrays, no eager init)."""
    from gl_slam_tpu import cli as j_cli
    from gl_slam_tpu.runtime import native_lib
    from gl_slam_tpu_torch.runtime import native_lib as t_native_lib
    import jax_weights
    from gl_slam_tpu_torch.slam import pipeline as t_pipeline
    runs = {}

    class SharedDraws(t_pipeline.TrackingPipeline):
        def __init__(self, *args, **kw):
            super().__init__(*args, draws=_jax_draws(128), **kw)

    def run(route):
        if route in runs:
            return runs[route]
        reports = []
        for name, main, extra in (("port", cli.main, ("--device", "cpu")),
                                  ("jax", j_cli.main, ())):
            out = str(tmp_path_factory.mktemp(f"{name}_{route}"))
            data = harris_dir if route == "harris" else kitti_dir
            argv = _per_frame_argv(data, out, route) + [
                "--live-viz", "4", "--checkpoint", *extra]
            stdout = io.StringIO()
            with pytest.MonkeyPatch.context() as mp, \
                    contextlib.redirect_stdout(stdout):
                mp.setattr(t_pipeline, "TrackingPipeline", SharedDraws)
                mp.setattr(native_lib, "available", lambda: False)
                mp.setattr(t_native_lib, "available", lambda: False)
                # the same weights without the eager Flax init
                mp.setattr(j_cli, "_load_learned_frontend",
                           jax_weights.cli_learned_frontend)
                assert main(argv) == 0
            reports.append((json.loads(stdout.getvalue()), out))
        runs[route] = (*reports[0], reports[1][0])
        return runs[route]
    return run


@pytest.mark.parametrize("route", list(PER_FRAME))
def test_cli_per_frame_route_like_jax(per_frame_run, route):
    """The report's keys are the JAX CLI's; frames, gating and BA runs
    equal. Tolerances: the oracle and Harris routes match by mutual NN on
    the same features with the same draws, so their ATE agrees to 1 mm
    (the report rounds to 0.1 mm) and their point counts to 1 %; the
    learned route runs bf16 networks whose roundings differ between the
    frameworks, so its ATE agrees only to within 0.1 m or 25 %. All 12
    frames are tracked, with one BA pass; the integer Harris corners give
    the classical route a poor trajectory (ATE ~0.9 m in both packages),
    the two others one within 0.5 m."""
    report, _, ref = per_frame_run(route)
    assert set(report) == set(ref)
    assert set(report["map"]) == set(ref["map"])
    assert set(report["stages"]) == set(ref["stages"]) == \
        {"bootstrap", "features", "track"}
    assert report["frontend"] == ref["frontend"]
    for k in ("frames_tracked", "frames_gated"):
        assert report[k] == ref[k], (k, report, ref)
    assert report["map"]["num_ba_runs"] == ref["map"]["num_ba_runs"]
    d_ate = abs(report["ate_rmse_m"] - ref["ate_rmse_m"])
    if route == "per-frame":
        assert d_ate <= max(0.1, 0.25 * ref["ate_rmse_m"]), (report, ref)
    else:
        assert d_ate <= 1e-3, (report, ref)
        assert abs(report["map"]["num_points"] - ref["map"]["num_points"]) \
            <= 0.01 * ref["map"]["num_points"], (report, ref)
    assert report["frames_tracked"] == 12, report
    assert report["map"]["num_ba_runs"] == 1, report
    assert report["ate_rmse_m"] < (2.0 if route == "harris" else 0.5), report


@pytest.mark.parametrize("route", list(PER_FRAME))
def test_cli_per_frame_route_writes_its_artifacts(per_frame_run, route):
    """trajectory.txt, metrics.jsonl (one row per tracked frame), map.json,
    trajectory.png, the state checkpoint (loadable into a fresh state of
    the run's configuration) and the live snapshot."""
    from gl_slam_tpu_torch.checkpoint import load_state
    from gl_slam_tpu_torch.slam.frontend import init_track_state
    report, out, _ = per_frame_run(route)
    for f in ARTIFACTS + ("metrics.jsonl", os.path.join("live", "live.json"),
                          os.path.join("ckpt", "state.npz")):
        assert os.path.exists(os.path.join(out, f)), f
    n = report["frames_tracked"]
    assert np.loadtxt(os.path.join(out, "trajectory.txt")).shape == (n, 12)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["frame"] for r in rows] == list(range(2, 12))
    assert set(rows[0]) == {"frame", "num_matches", "num_map_matches",
                            "num_new_points"}
    with open(os.path.join(out, "live", "live.json")) as f:
        live = json.load(f)
    assert 4 <= len(live["keyframe_centers"]) <= n
    cfg = cli._build_config(_parsed(_per_frame_argv("x", out, route)),
                            "mutual_nn")
    state = load_state(os.path.join(out, "ckpt"),
                       init_track_state(cfg, device="cpu"))
    assert int(state.map.num_kf) == n
    np.testing.assert_allclose(
        np.loadtxt(os.path.join(out, "trajectory.txt"))[-1, [3, 7, 11]],
        -(state.map.kf_R[n - 1].T @ state.map.kf_t[n - 1]).numpy(),
        atol=1e-5)


def _parsed(argv):
    """The `run` namespace of `argv` with the presets' sizes filled in, as
    cli.main resolves them."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "cmd_run", lambda a: seen.setdefault("args", a))
        cli.main(argv)
    return seen["args"]


def _euroc_dir(root):
    """A two-frame EuRoC layout: 10x12 frames, identity extrinsic, GT at
    the camera stamps."""
    from PIL import Image
    cam = os.path.join(root, "mav0", "cam0")
    os.makedirs(os.path.join(cam, "data"))
    os.makedirs(os.path.join(root, "mav0", "state_groundtruth_estimate0"))
    with open(os.path.join(cam, "sensor.yaml"), "w") as f:
        f.write("T_BS:\n  data: [1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, "
                "0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]\n"
                "resolution: [12, 10]\nintrinsics: [50.0, 51.0, 6.0, 5.0]\n")
    rows = ["#timestamp,px,py,pz,qw,qx,qy,qz"]
    for i, ts in enumerate((100, 200)):
        img = (np.random.default_rng(i).random((10, 12)) * 255).astype(
            np.uint8)
        Image.fromarray(img, mode="L").save(os.path.join(cam, "data",
                                                         f"{ts}.png"))
        rows.append(f"{ts},{0.5 * i},0,0,1,0,0,0")
    with open(os.path.join(root, "mav0", "state_groundtruth_estimate0",
                           "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return root


def test_open_dataset_reads_each_layout(kitti_dir, tmp_path, monkeypatch):
    """KITTI (here with PIL; the native loader's branch is in
    tests/test_torch_runtime.py), EuRoC (chosen by its `mav0/` directory)
    and synthetic through `_open_dataset`, frames cropped to --height x
    --width."""
    from gl_slam_tpu_torch.runtime import native_lib
    monkeypatch.setattr(native_lib, "available", lambda: False)
    args = argparse.Namespace(
        dataset=kitti_dir, sequence="00", height=150, width=200, kpts=96,
        landmarks=300, last_frame=3, desc_dim=64, scene_seed=7)
    seq, K, gt_R, gt_t, frame, gate = cli._open_dataset(args)
    assert isinstance(seq, KittiSequence) and gt_R.shape == (20, 3, 3)
    np.testing.assert_array_equal(K, seq.K)
    np.testing.assert_array_equal(frame(3), seq.frame(3)[:150, :200])
    assert not gate(0, 1, 0.01, 0.01) and gate(0, 1, 5.0, 5.0)
    args.dataset = _euroc_dir(str(tmp_path))
    seq, K, gt_R, gt_t, frame, gate = cli._open_dataset(args)
    assert K[0, 0] == 50.0 and K[1, 2] == 5.0
    assert frame(1).shape == (10, 12)
    np.testing.assert_array_equal(frame(1), seq.frame(1))
    np.testing.assert_allclose(-gt_R[1].T @ gt_t[1], [0.5, 0.0, 0.0])
    assert gate(0, 1, 1.0, 1.0) and not gate(0, 1, 0.1, 1.0)
    args.dataset = "synthetic"
    scene, K, gt_R, _, frame, gate = cli._open_dataset(args)
    assert gate is None and gt_R.shape == (4, 3, 3)
    assert frame(2).shape == (150, 200)
