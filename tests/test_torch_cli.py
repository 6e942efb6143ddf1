"""The port's command-line entry point on a KITTI-layout directory, on the
CPU.

The dataset is the one of tests/test_cli_e2e.py (a 160x240 rendered scene,
seed 23, 20 frames, written by the port's `write_kitti_sequence`); the runs
take that test's chunked arguments (tiny preset, chunk 4, BA every 4: a
bootstrap, four chunks and a tail of 2 frames padded to 4) and its bounds.
The JAX CLI itself is not run here (it builds the JAX package's native
frame loader); its report keys are read from its source.
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
    report, _ = cli_run(None)
    keys = _jax_chunked_report_keys()
    assert "ate_rmse_m" in keys and "frames_rejected" in keys
    assert set(report) == keys


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


@pytest.mark.parametrize("extra", [("--frontend", "oracle"),
                                   ("--frontend", "harris"),
                                   ("--frontend", "superpoint",
                                    "--per-frame")],
                         ids=["oracle", "harris", "per-frame"])
def test_cli_per_frame_routes_raise(tmp_path, extra):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["run", "--out", str(tmp_path), "--device", "cpu", *extra])
    assert os.listdir(tmp_path) == []


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


def test_open_dataset_reads_each_layout(kitti_dir, tmp_path):
    """KITTI, EuRoC (chosen by its `mav0/` directory) and synthetic through
    `_open_dataset`, frames cropped to --height x --width."""
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
