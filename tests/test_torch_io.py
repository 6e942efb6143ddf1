"""Dataset I/O, metrics, trajectory files and the map snapshot: the port
against the JAX package.

The KITTI and EuRoC fixtures are those of tests/test_io.py (files the test
writes, pixels from a numpy seed); the synthetic scene is rendered from a
seed. Host numpy code on both sides, so frames, text and snapshots must be
equal exactly and metrics agree to 1e-12.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from gl_slam_tpu import checkpoint as j_ckpt
from gl_slam_tpu import metrics as j_metrics
from gl_slam_tpu.io import euroc as j_euroc
from gl_slam_tpu.io import kitti as j_kitti
from gl_slam_tpu.io import synthetic as j_synthetic
from gl_slam_tpu.viz import viewer as j_viewer
from gl_slam_tpu_torch import checkpoint as t_ckpt
from gl_slam_tpu_torch import metrics as t_metrics
from gl_slam_tpu_torch.io import euroc as t_euroc
from gl_slam_tpu_torch.io import kitti as t_kitti
from gl_slam_tpu_torch.io import synthetic as t_synthetic
from gl_slam_tpu_torch.slam.state import init_map_state
from gl_slam_tpu_torch.viz import viewer as t_viewer


@pytest.fixture()
def kitti_root(tmp_path):
    seq = tmp_path / "sequences" / "07"
    (seq / "image_0").mkdir(parents=True)
    (tmp_path / "poses").mkdir()
    (seq / "calib.txt").write_text(
        "P0: 700.0 0.0 600.0 0.0 0.0 700.0 180.0 0.0 0.0 0.0 1.0 0.0\n")
    rows = []
    for i in range(3):
        T = np.eye(4)[:3]
        T[2, 3] = float(i)      # forward motion 1 m/frame
        rows.append(" ".join(str(v) for v in T.reshape(-1)))
    (tmp_path / "poses" / "07.txt").write_text("\n".join(rows) + "\n")
    for i in range(3):
        img = (np.random.default_rng(i).random((8, 16)) * 255).astype(
            np.uint8)
        Image.fromarray(img, mode="L").save(seq / "image_0" / f"{i:06d}.png")
    return str(tmp_path)


@pytest.fixture()
def euroc_root(tmp_path):
    cam = tmp_path / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    gt = tmp_path / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir(parents=True)
    (cam / "sensor.yaml").write_text("""\
sensor_type: camera
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
         -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375]
distortion_model: radial-tangential
distortion_coefficients: [-0.28, 0.07, 0.0002, 0.00002]
""")
    ts = [1403636579763555584, 1403636579813555456, 1403636579863555584]
    for i, t in enumerate(ts):
        img = (np.random.default_rng(i).random((480 // 60, 752 // 94))
               * 255).astype(np.uint8)
        Image.fromarray(img, mode="L").save(cam / "data" / f"{t}.png")
    lines = ["#timestamp,px,py,pz,qw,qx,qy,qz,vx,vy,vz,bw,bw,bw,ba,ba,ba"]
    for i, t in enumerate(ts):
        # GT a few microseconds off the camera stamps, rotating about z
        a = 0.1 * i
        lines.append(f"{t + 3000},{0.5 * i},{0.2 * i},0.0,{np.cos(a / 2)},"
                     f"0.0,0.0,{np.sin(a / 2)},0,0,0,0,0,0,0,0,0")
    (gt / "data.csv").write_text("\n".join(lines) + "\n")
    return str(tmp_path)


def test_kitti_sequence_like_jax(kitti_root):
    j, t = j_kitti.KittiSequence(kitti_root, "07"), \
        t_kitti.KittiSequence(kitti_root, "07")
    np.testing.assert_array_equal(t.K, j.K)
    np.testing.assert_array_equal(t.gt_R, j.gt_R)
    np.testing.assert_array_equal(t.gt_t, j.gt_t)
    assert t.num_frames == j.num_frames == 3
    for i in range(3):
        np.testing.assert_array_equal(t.frame(i), j.frame(i))
        assert t.frame(i).dtype == np.float32
    assert t.gt_scale(0, 2) == j.gt_scale(0, 2) == 2.0
    for mag, rot in ((2.0, 1.0), (0.5, 1.0), (2.0, 0.0)):
        assert t.gt_motion_small(0, 1, mag, rot) == \
            j.gt_motion_small(0, 1, mag, rot)


def test_kitti_sequence_without_poses(kitti_root):
    os.remove(os.path.join(kitti_root, "poses", "07.txt"))
    seq = t_kitti.KittiSequence(kitti_root, "07")
    assert seq.gt_R is None and seq.gt_scale(0, 1) == 1.0
    assert not seq.gt_motion_small(0, 1, 2.0, 1.0)
    with pytest.raises(ValueError, match="P1 not found"):
        t_kitti.load_camera_matrix(os.path.join(seq.seq_dir, "calib.txt"),
                                   "P1")


def test_euroc_sequence_like_jax(euroc_root):
    j, t = j_euroc.EurocSequence(euroc_root), \
        t_euroc.EurocSequence(euroc_root)
    np.testing.assert_array_equal(t.K, j.K)
    np.testing.assert_array_equal(t.T_BS, j.T_BS)
    assert (t.height, t.width) == (j.height, j.width) == (480, 752)
    assert t.timestamps == j.timestamps
    np.testing.assert_array_equal(t.gt_R, j.gt_R)
    np.testing.assert_array_equal(t.gt_t, j.gt_t)
    for i in range(3):
        np.testing.assert_array_equal(t.frame(i), j.frame(i))
    assert t.gt_scale(0, 2) == j.gt_scale(0, 2) > 0.5
    for mag, rot in ((1.0, 10.0), (1.0, 1.0), (0.1, 10.0)):
        assert t.gt_motion_small(0, 1, mag, rot) == \
            j.gt_motion_small(0, 1, mag, rot)
    q = np.random.default_rng(0).standard_normal(4)
    np.testing.assert_array_equal(t_euroc._quat_to_R(*q),
                                  j_euroc._quat_to_R(*q))


def test_write_kitti_sequence_like_jax(tmp_path):
    scene = j_synthetic.make_scene(num_landmarks=300, num_frames=3,
                                   height=48, width=64, desc_dim=8, seed=5)
    tscene = t_synthetic.make_scene(num_landmarks=300, num_frames=3,
                                    height=48, width=64, desc_dim=8, seed=5)
    jr = j_kitti.write_kitti_sequence(str(tmp_path / "j"), scene, 3,
                                      max_keypoints=64)
    tr = t_kitti.write_kitti_sequence(str(tmp_path / "t"), tscene, 3,
                                      max_keypoints=64)
    for rel in ("sequences/00/calib.txt", "poses/00.txt"):
        with open(os.path.join(jr, rel), "rb") as a, \
                open(os.path.join(tr, rel), "rb") as b:
            assert a.read() == b.read(), rel
    seq_j = j_kitti.KittiSequence(jr)
    seq_t = t_kitti.KittiSequence(tr)
    assert seq_t.num_frames == 3
    for i in range(3):
        px = np.asarray(Image.open(t_kitti.frame_path(seq_t.seq_dir, i)))
        assert px.dtype == np.uint8 and px.shape == (48, 64)
        np.testing.assert_array_equal(seq_t.frame(i), seq_j.frame(i))
    assert 0.5 < seq_t.gt_scale(0, 1) < 2.0


def test_frame_prefetcher_order_and_errors():
    got = list(t_kitti.FramePrefetcher(lambda i: np.full(2, i), range(7),
                                       depth=2))
    assert [i for i, _ in got] == list(range(7))
    assert all((a == i).all() for i, a in got)

    def bad(i):
        if i == 3:
            raise OSError("unreadable frame 3")
        return i

    it = iter(t_kitti.FramePrefetcher(bad, range(6), depth=2))
    assert [next(it)[0] for _ in range(3)] == [0, 1, 2]
    with pytest.raises(OSError, match="frame 3"):
        next(it)


def _trajectories(rng, F=12):
    """Two world->camera trajectories (estimate, ground truth): random
    rotations, the estimate a rotated, shifted, scaled and noisy copy."""
    def rot(v):
        th = np.linalg.norm(v)
        k = v / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    R_gt = np.stack([rot(rng.standard_normal(3)) for _ in range(F)])
    c_gt = np.cumsum(rng.standard_normal((F, 3)), axis=0)
    t_gt = -np.einsum('fij,fj->fi', R_gt, c_gt)
    A = rot(np.array([0.1, -0.3, 0.2]))
    c_est = 1.3 * c_gt @ A.T + [1.0, -2.0, 0.5] \
        + 0.01 * rng.standard_normal((F, 3))
    R_est = np.stack([R @ A.T @ rot(0.01 * rng.standard_normal(3))
                      for R in R_gt])
    t_est = -np.einsum('fij,fj->fi', R_est, c_est)
    return R_est, t_est, R_gt, t_gt


def test_metrics_like_jax():
    R_est, t_est, R_gt, t_gt = _trajectories(np.random.default_rng(1))
    for a, b in zip(t_metrics.per_frame_pose_errors(R_est, t_est, R_gt, t_gt),
                    j_metrics.per_frame_pose_errors(R_est, t_est, R_gt,
                                                    t_gt)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    c_est = t_metrics.camera_centers(R_est, t_est)
    c_gt = t_metrics.camera_centers(R_gt, t_gt)
    np.testing.assert_allclose(c_est, j_metrics.camera_centers(R_est, t_est),
                               rtol=0, atol=1e-12)
    for with_scale in (False, True):
        for a, b in zip(t_metrics.umeyama_alignment(c_est, c_gt, with_scale),
                        j_metrics.umeyama_alignment(c_est, c_gt,
                                                    with_scale)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        for align in (False, True):
            got = t_metrics.ate_rmse(c_est, c_gt, align, with_scale)
            assert abs(got - j_metrics.ate_rmse(c_est, c_gt, align,
                                                with_scale)) <= 1e-12
    # the alignment removes the similarity: ~ the 0.01 m noise remains
    assert t_metrics.ate_rmse(c_est, c_gt, True, True) < 0.05 \
        < t_metrics.ate_rmse(c_est, c_gt, False)
    err = np.random.default_rng(2).random(50)
    valid = err > 0.3
    for v in (None, valid, np.zeros(50, bool)):
        a = t_metrics.reprojection_stats(err, v)
        b = j_metrics.reprojection_stats(err, v)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])), k


def test_kitti_trajectory_files_like_jax(tmp_path):
    R, t, _, _ = _trajectories(np.random.default_rng(3), F=9)
    R, t = R.astype(np.float32), t.astype(np.float32)  # as a run exports
    jp, tp = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    j_ckpt.export_kitti_trajectory(jp, R, t)
    t_ckpt.export_kitti_trajectory(tp, R, t)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    R2, t2 = t_ckpt.load_kitti_trajectory(tp)
    jR2, jt2 = j_ckpt.load_kitti_trajectory(jp)
    np.testing.assert_array_equal(R2, jR2)
    np.testing.assert_array_equal(t2, jt2)
    # nine significant digits of float32 poses
    np.testing.assert_allclose(R2, R, atol=1e-6)
    np.testing.assert_allclose(t2, t, atol=1e-5)


def _map_state(rng):
    """A port MapState with 6 of 8 keyframes, 40 of 64 points, some bad or
    invalid, and covisibility rows with -1 holes."""
    m = init_map_state(8, 64, 16, 8, 4, device="cpu")
    R, t, _, _ = _trajectories(rng, F=8)
    nbr = rng.integers(-1, 6, size=(8, m.covis_nbr.shape[1]))
    return m._replace(
        num_kf=torch.tensor(6, dtype=torch.int32),
        num_pts=torch.tensor(40, dtype=torch.int32),
        kf_R=torch.from_numpy(R.astype(np.float32)),
        kf_t=torch.from_numpy(t.astype(np.float32)),
        pts_xyz=torch.from_numpy(rng.standard_normal((64, 3)).astype(
            np.float32)),
        pts_valid=torch.from_numpy(rng.random(64) < 0.8),
        pts_bad=torch.from_numpy(rng.random(64) < 0.2),
        covis_nbr=torch.from_numpy(nbr.astype(np.int32)))


def test_map_snapshot_like_jax(tmp_path):
    m = _map_state(np.random.default_rng(4))
    snap = t_viewer.MapSnapshot(m)
    ref = j_viewer.MapSnapshot(type(m)(*(x.float().numpy() if x.dtype ==
                                         torch.bfloat16 else x.numpy()
                                         for x in m)))
    np.testing.assert_array_equal(snap.centers, ref.centers)
    np.testing.assert_array_equal(snap.points, ref.points)
    assert snap.covis_edges == ref.covis_edges
    assert len(snap.centers) == 6 and 0 < len(snap.points) < 40
    snap.to_json(str(tmp_path / "t.json"))
    ref.to_json(str(tmp_path / "j.json"))
    with open(tmp_path / "t.json") as a, open(tmp_path / "j.json") as b:
        assert json.load(a) == json.load(b)
    assert t_viewer.MapSnapshot(m, max_points=5).points.shape == (5, 3)


def test_renderers_write_png_or_report_no_matplotlib(tmp_path, monkeypatch):
    snap = t_viewer.MapSnapshot(_map_state(np.random.default_rng(5)))
    img = np.random.default_rng(6).random((24, 32))
    kp = np.random.default_rng(7).random((10, 2)) * [32, 24]
    valid = np.arange(10) < 8
    tracked = np.arange(10) % 2 == 0
    assert t_viewer.render_topdown(snap, str(tmp_path / "a.png"),
                                   gt_centers=snap.centers + 0.1)
    assert t_viewer.render_topdown(snap, str(tmp_path / "b.png"),
                                   follow_center=snap.centers[-1],
                                   follow_radius_m=5.0)
    assert t_viewer.render_keypoint_overlay(img, kp, valid,
                                            str(tmp_path / "c.png"), tracked)
    for name in ("a.png", "b.png", "c.png"):
        assert os.path.getsize(tmp_path / name) > 1000, name
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not t_viewer.render_topdown(snap, str(tmp_path / "d.png"))
    assert not t_viewer.render_keypoint_overlay(img, kp, valid,
                                                str(tmp_path / "e.png"))
    assert not os.path.exists(tmp_path / "d.png")
