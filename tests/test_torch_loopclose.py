"""Loop closing in the port against the JAX package.

Both detection paths (the map archive's mutual NN and the keyframe
database with the port's mutual-NN matcher standing in for the learned
one, as in the JAX test), the pose graph, the map correction and the
closure in and out of its window, on the inputs of tests/test_loopclose.py:
the JAX per-frame `TrackingPipeline` builds the map (10 frames of the
240x320 synthetic scene with GT-stable descriptors) and
`frontend.track_state_from_numpy` carries it across.
Every PnP RANSAC of the port takes the Gumbel draws the JAX key gives.
Both sides run in float32 at "highest" matmul precision
(tests/conftest.py). log_so3, the solvers and the PnP pieces alone:
tests/test_torch_loopclose_geometry.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu import config as j_config
from gl_slam_tpu.geometry import se3 as j_se3
from gl_slam_tpu.io import synthetic
from gl_slam_tpu.ops import match as j_match
from gl_slam_tpu.slam import frontend as j_frontend
from gl_slam_tpu.slam import loopclose as j_lc
from gl_slam_tpu.slam.pipeline import TrackingPipeline
from gl_slam_tpu_torch import config as t_config
from gl_slam_tpu_torch.geometry import se3 as t_se3
from gl_slam_tpu_torch.ops import match as t_match
from gl_slam_tpu_torch.slam import frontend as t_frontend
from gl_slam_tpu_torch.slam import loopclose as t_lc

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

H, W, N, D, NF = 240, 320, 256, 64, 10


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# detection, pose graph, correction, closure on the JAX pipeline's map


def _cfg(c=j_config):
    """test_loopclose.py's config (its keyframe-database size), built from
    the JAX package's config module or the port's."""
    return c.SLAMConfig(
        frontend=c.FrontendConfig(image_height=H, image_width=W,
                                  max_keypoints=N, descriptor_dim=D),
        geometry=c.GeometryConfig(essential_hypotheses=128,
                                  triangulation_reproj_px=0.5),
        ba=c.BAConfig(max_window_cameras=12, max_window_points=2048,
                      full_ba_iters=10, pose_only_iters=15),
        map=c.MapConfig(max_keyframes=64, max_points=8192,
                        covis_max_points=256, covis_edge_threshold=10,
                        loop_db_keypoints=128))


def _t_cfg(cfg):
    return _cfg(t_config)


@pytest.fixture(scope="module")
def tracked():
    """The JAX pipeline's state after 10 frames (test_loopclose.py's
    detect-loop fixture), the scene and its observations."""
    cfg = _cfg()
    scene = synthetic.make_scene(num_landmarks=3000, num_frames=NF,
                                 height=H, width=W, desc_dim=D, seed=42)
    obs = [synthetic.observe_frame(scene, i, max_keypoints=N, seed=9)
           for i in range(NF)]
    pipe = TrackingPipeline(cfg, scene.K, enable_ba=False)
    c0 = -scene.poses_R[0].T @ scene.poses_t[0]
    c1 = -scene.poses_R[1].T @ scene.poses_t[1]
    pipe.bootstrap((obs[0].keypoints, obs[0].descriptors, obs[0].valid, 0),
                   (obs[1].keypoints, obs[1].descriptors, obs[1].valid, 1),
                   gt_scale=float(np.linalg.norm(c1 - c0)))
    for i in range(2, NF):
        pipe.step(obs[i].keypoints, obs[i].descriptors, obs[i].valid, i)
    pipe.block()
    jstate = pipe.state
    tstate = t_frontend.track_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate))
    return cfg, scene, obs, jstate, tstate


def _frames(obs):
    """The revisit of frame 1, as FrameFeatures of each package."""
    o = obs[1]
    fj = j_frontend.FrameFeatures(
        kpts=jnp.asarray(o.keypoints), desc=jnp.asarray(o.descriptors),
        valid=jnp.asarray(o.valid), frame_idx=jnp.asarray(10, jnp.int32))
    ft = t_frontend.FrameFeatures(_t(o.keypoints), _t(o.descriptors),
                                  _t(o.valid), None)
    return fj, ft


def _gumbel(key, Q, hyp, n):
    keys = jax.random.split(key, Q)
    return _t(jax.vmap(lambda k: jax.random.gumbel(k, (hyp, n),
                                                   jnp.float32))(keys))


def _assert_detections_match(dt, dj, fields):
    """The verdict and the counters always; the pose and the inliers where
    the detection holds (both sides fit the same sample)."""
    for name in ("ok",) + fields:
        assert int(getattr(dt, name)) == int(getattr(dj, name)), name
    if bool(dj.ok):
        assert int(dt.loop_kf) == int(dj.loop_kf)
        assert int(dt.num_inliers) == int(dj.num_inliers)
        np.testing.assert_allclose(dt.R.numpy(), _np(dj.R), atol=1e-4)
        np.testing.assert_allclose(dt.t.numpy(), _np(dj.t), atol=1e-3)


def test_detect_loop_mutual_nn_path_matches_jax(tracked):
    cfg, scene, obs, jstate, tstate = tracked
    fj, ft = _frames(obs)
    key = jax.random.PRNGKey(5)
    K = scene.K.astype(np.float32)
    dj = j_lc.detect_loop(cfg, jnp.asarray(K), jstate.map, fj, key,
                          min_gap=5, max_candidates=4096, min_inliers=20)
    g = _gumbel(key, 4, cfg.geometry.pnp_hypotheses, 4096)
    dt = t_lc.detect_loop(_t_cfg(cfg), _t(K), tstate.map, ft, g, min_gap=5,
                          max_candidates=4096, min_inliers=20)
    assert bool(dj.ok)
    _assert_detections_match(dt, dj, ("cur_kf",))
    rot_err = float(t_se3.rotation_angle_deg(
        _t(scene.poses_R[1], torch.float32).T @ dt.R))
    assert rot_err < 0.3, rot_err


def _j_nn(kpts0, desc0, valid0, kpts1, desc1, valid1):
    return j_match.mutual_nn_match(desc0, valid0, desc1, valid1,
                                   min_score=0.7)


def _t_nn(kpts0, desc0, valid0, kpts1, desc1, valid1):
    """The port's mutual NN over detect_loop_db's candidate axis."""
    outs = [t_match.mutual_nn_match(desc0[q], valid0[q], desc1[q],
                                    valid1[q], min_score=0.7)
            for q in range(desc0.shape[0])]
    return t_match.MatchResult(*(torch.stack(x) for x in zip(*outs)))


@pytest.mark.parametrize("drift", [0.3, 30.0], ids=["revisit", "too-far"])
def test_detect_loop_db_matches_jax(tracked, drift):
    """A revisit of frame 1 with a small pose drift (a candidate verifies)
    and with a drift beyond the retrieval radius (no candidate: both run
    the matcher on clipped, -inf-scored keyframes and must reject)."""
    min_gap = 5
    cfg, scene, obs, jstate, tstate = tracked
    fj, ft = _frames(obs)
    key = jax.random.PRNGKey(5)
    K = scene.K.astype(np.float32)
    R_cur = scene.poses_R[1].astype(np.float32)
    t_cur = (scene.poses_t[1] + drift).astype(np.float32)
    dj = j_lc.detect_loop(cfg, jnp.asarray(K), jstate.map, fj, key,
                          min_gap=min_gap, min_inliers=20, matcher=_j_nn,
                          R_cur=jnp.asarray(R_cur), t_cur=jnp.asarray(t_cur))
    rt = cfg.runtime
    g = _gumbel(key, rt.loop_candidates, cfg.geometry.pnp_hypotheses,
                cfg.map.loop_db_keypoints)
    dt = t_lc.detect_loop(_t_cfg(cfg), _t(K), tstate.map, ft, g,
                          min_gap=min_gap, min_inliers=20, matcher=_t_nn,
                          R_cur=_t(R_cur), t_cur=_t(t_cur))
    _assert_detections_match(dt, dj, ("cur_kf", "n_vis", "n_good",
                                      "region_votes", "n_cons",
                                      "pnp_raw_ok"))
    assert bool(dt.ok) == (drift < 1.0)
    assert int(dt.n_vis) == (0 if drift > 1.0 else int(dj.n_vis))


GRAPH_C = 6     # every pose graph here: one compile of the JAX solve


def _circle_graph(C=GRAPH_C):
    """tests/test_loopclose.py::test_pose_graph_corrects_drift's problem,
    on C nodes."""
    radius = 10.0
    angles = np.linspace(0, 2 * np.pi, C, endpoint=False)
    R_gt = np.zeros((C, 3, 3), np.float32)
    t_gt = np.zeros((C, 3), np.float32)
    for k, a in enumerate(angles):
        c, s = np.cos(a), np.sin(a)
        R_gt[k] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]).T
        t_gt[k] = -R_gt[k] @ np.array([radius * s, 0.0,
                                       radius * (1 - c)])
    Zr = np.einsum('eij,ekj->eik', R_gt[1:], R_gt[:-1])
    Zt = t_gt[1:] - np.einsum('eij,ej->ei', Zr, t_gt[:-1])
    rng = np.random.default_rng(3)
    R_est, t_est = [R_gt[0]], [t_gt[0]]
    for e in range(C - 1):
        dR = _np(j_se3.exp_so3(jnp.asarray(
            rng.normal(scale=0.004, size=3).astype(np.float32))))
        R_est.append(dR @ Zr[e] @ R_est[-1])
        t_est.append(dR @ (Zr[e] @ t_est[-1] + Zt[e])
                     + rng.normal(scale=0.01, size=3).astype(np.float32))
    Zr_loop = R_gt[-1] @ R_gt[0].T
    edges = (np.r_[np.arange(C - 1), 0].astype(np.int32),
             np.r_[np.arange(1, C), C - 1].astype(np.int32),
             np.concatenate([Zr, Zr_loop[None]]).astype(np.float32),
             np.concatenate([Zt, (t_gt[-1] - Zr_loop @ t_gt[0])[None]])
             .astype(np.float32),
             np.r_[np.ones(C - 1), 4.0].astype(np.float32),
             np.arange(C) == 0)
    return (np.stack(R_est).astype(np.float32),
            np.stack(t_est).astype(np.float32), edges, t_gt)


def test_optimize_pose_graph_matches_jax():
    R_est, t_est, edges, t_gt = _circle_graph()
    # close_loop's iteration counts for C nodes
    kw = dict(gn_iters=8, cg_iters=2 * GRAPH_C + 64)
    Rj, tj, cj = j_lc.optimize_pose_graph(
        jnp.asarray(R_est), jnp.asarray(t_est),
        *(jnp.asarray(e) for e in edges), **kw)
    Rt, tt, ct = t_lc.optimize_pose_graph(
        _t(R_est), _t(t_est), *(_t(e) for e in edges), **kw)
    # a 36x36 dense f32 solve per iteration, 8 iterations from the same
    # start: poses to ~1e-4 on a 20 m circle
    np.testing.assert_allclose(Rt.numpy(), _np(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), _np(tj), atol=5e-4)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-2, atol=1e-7)
    drift_before = np.linalg.norm(t_est[-1] - t_gt[-1])
    drift_after = np.linalg.norm(tt.numpy()[-1] - t_gt[-1])
    assert drift_after < 0.35 * drift_before, (drift_before, drift_after)


def _assert_maps_close(mt, mj, atol_t=1e-4):
    np.testing.assert_allclose(mt.kf_R.numpy(), _np(mj.kf_R), atol=1e-5)
    np.testing.assert_allclose(mt.kf_t.numpy(), _np(mj.kf_t), atol=atol_t)
    np.testing.assert_allclose(mt.pts_xyz.numpy(), _np(mj.pts_xyz),
                               atol=10 * atol_t)
    np.testing.assert_allclose(mt.kf_db_xyz.numpy(), _np(mj.kf_db_xyz),
                               atol=10 * atol_t)


def test_apply_pose_graph_correction_matches_jax(tracked):
    _, _, _, jstate, tstate = tracked
    m = jstate.map
    dR = j_se3.exp_so3(jnp.asarray([0.0, 0.05, 0.0], jnp.float32))
    new_R = jnp.einsum('kij,jl->kil', m.kf_R, dR.T)
    new_t = m.kf_t + jnp.asarray([0.1, 0.0, -0.2])
    mj = j_lc.apply_pose_graph_correction(m, new_R, new_t)
    mt = t_lc.apply_pose_graph_correction(tstate.map, _t(new_R), _t(new_t))
    # 3x3 products of metre-scale points in f32
    _assert_maps_close(mt, mj, atol_t=1e-5)
    # a point keeps its coordinates in its anchor keyframe
    a = int(m.pts_first_kf[5])
    before = _np(m.kf_R[a] @ m.pts_xyz[5] + m.kf_t[a])
    after = (mt.kf_R[a] @ mt.pts_xyz[5] + mt.kf_t[a]).numpy()
    np.testing.assert_allclose(after, before, atol=1e-4)


def _t_det(dj):
    return t_lc.LoopDetection(
        ok=_t(dj.ok), loop_kf=_t(dj.loop_kf), R=_t(dj.R), t=_t(dj.t),
        num_inliers=_t(dj.num_inliers))


@pytest.mark.parametrize("loop_kf", [5, 1], ids=["in-window",
                                                 "out-of-window"])
def test_close_loop_matches_jax(tracked, loop_kf):
    """A verified revisit: the absolute GT pose of the last frame measured
    against keyframe 5 or keyframe 1, with the graph over the last 6
    keyframes (4-9): keyframe 1 lies before the window, and its edge
    re-anchors to the window's fixed node 0."""
    window = GRAPH_C
    cfg, scene, _, jstate, tstate = tracked
    last = int(jstate.map.num_kf) - 1
    dj = j_lc.LoopDetection(
        ok=jnp.asarray(True), loop_kf=jnp.asarray(loop_kf, jnp.int32),
        R=jnp.asarray(scene.poses_R[last], jnp.float32),
        t=jnp.asarray(scene.poses_t[last], jnp.float32),
        num_inliers=jnp.asarray(100, jnp.int32))
    K = scene.K.astype(np.float32)
    sj = j_lc.close_loop(cfg, jnp.asarray(K), jstate, dj,
                         max_graph_kf=window)
    st = t_lc.close_loop(_t_cfg(cfg), _t(K), tstate, _t_det(dj),
                         max_graph_kf=window)
    # the warm start in float64, then 8 dense GN steps in f32
    _assert_maps_close(st.map, sj.map, atol_t=2e-4)
    np.testing.assert_allclose(st.R_cur.numpy(), _np(sj.R_cur), atol=1e-5)
    np.testing.assert_allclose(st.t_cur.numpy(), _np(sj.t_cur), atol=2e-4)
    before = np.linalg.norm(_np(jstate.map.kf_t[last])
                            - scene.poses_t[last])
    after = np.linalg.norm(st.map.kf_t[last].numpy() - scene.poses_t[last])
    assert after < max(0.5 * before, 0.02), (before, after)
    if window < last:
        # keyframes before the window stay where they were
        first = last + 1 - window
        np.testing.assert_array_equal(st.map.kf_t[:first].numpy(),
                                      tstate.map.kf_t[:first].numpy())
