"""The merged and batched re-observation modes: the port against JAX.

`reobs_mode="merged"` runs one synthetic pass over the union of the map
window and the covisibility expansion at the predicted pose
(`match_unified`); `"batched"` keeps both candidate pools and their
projection poses but runs them as ONE matcher call over a leading set axis
of 2 (`match_batched`). Two levels, each against the JAX package (the
chunked learned route is in tests/test_torch_reobs_modes_chunked.py):

  * the two functions on the JAX per-frame pipeline's map carried to the
    port (`frontend.track_state_from_numpy`), by mutual nearest neighbours
    and by the tiny LightGlue matcher with the fused assignment: the ids
    and the candidate counts are equal exactly;
  * TrackingPipeline over tests/test_tracking.py's scene (10 frames, BA
    off, the JAX key recurrence's RANSAC draws replayed, as in
    tests/test_torch_pipeline.py), held to that file's tolerances and to
    the bounds of test_tracking.py's own tests of the two modes.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu import config as j_config
from gl_slam_tpu.checkpoint import load_params as j_load
from gl_slam_tpu.io import synthetic
from gl_slam_tpu.models.lightglue import LightGlueNet as JLightGlue
from gl_slam_tpu.models.lightglue import normalize_keypoints
from gl_slam_tpu.ops import assignment as j_asg
from gl_slam_tpu.ops import match as j_match
from gl_slam_tpu.slam import frontend as j_frontend
from gl_slam_tpu.slam import reobserve as j_reobs
from gl_slam_tpu.slam.pipeline import TrackingPipeline as JPipeline
from gl_slam_tpu.train import e2e as j_e2e
from gl_slam_tpu_torch import checkpoint as ckpt
from gl_slam_tpu_torch import config as t_config
from gl_slam_tpu_torch import metrics as t_metrics
from gl_slam_tpu_torch.models.lightglue import LightGlueNet
from gl_slam_tpu_torch.slam import frontend as t_frontend
from gl_slam_tpu_torch.slam import fused as t_fused
from gl_slam_tpu_torch.slam import reobserve as t_reobs
from gl_slam_tpu_torch.slam.pipeline import TrackingPipeline

import test_torch_pipeline as tp_mod
import jax_weights

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

H, W, N, D = tp_mod.H, tp_mod.W, tp_mod.N, tp_mod.D
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
MODES = ["merged", "batched"]


def with_mode(cfg, mode):
    return dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, reobs_mode=mode))


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(num_landmarks=3000, num_frames=16, height=H,
                                width=W, desc_dim=D, seed=42)


def _observations(scene, n):
    return [synthetic.observe_frame(scene, i, max_keypoints=N, seed=9)
            for i in range(n)]


# --- the per-frame route ----------------------------------------------------

@pytest.fixture(scope="module")
def per_frame_runs(scene):
    """(JAX pipeline, port pipeline) per mode after 10 frames, BA off, on
    the same RANSAC draws."""
    obs = _observations(scene, 10)
    runs = {}
    for mode in MODES:
        jcfg = with_mode(tp_mod._cfg(j_config), mode)
        jp = JPipeline(jcfg, scene.K, enable_ba=False)
        tp_mod._drive(jp, scene, obs)
        draws = tp_mod.jax_draws(jcfg, 9)
        tp = TrackingPipeline(with_mode(tp_mod._cfg(t_config), mode),
                              scene.K, enable_ba=False, device="cpu",
                              draws=draws)
        tp_mod._drive(tp, scene, obs)
        assert next(tp._draws, None) is None     # one draw set per step
        runs[mode] = (jp, tp)
    return runs


# --- the two functions on a carried map -----------------------------------

@pytest.fixture(scope="module")
def carried(per_frame_runs, scene):
    """The JAX merged-mode pipeline's state after frames 0-9, carried to
    the port, with frame 10's features and K."""
    jstate = per_frame_runs["merged"][0].state
    tstate = t_frontend.track_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate))
    o = synthetic.observe_frame(scene, 10, max_keypoints=N, seed=9)
    arrays = (np.float32(o.keypoints), np.float32(o.descriptors),
              np.asarray(o.valid))
    K = np.asarray(scene.K, np.float32)
    return (jstate, tstate,
            j_frontend.FrameFeatures(*map(jnp.asarray, arrays),
                                     jnp.int32(10)),
            t_frontend.FrameFeatures(*map(torch.from_numpy, arrays),
                                     torch.tensor(10)),
            (jnp.asarray(K), torch.from_numpy(K)))


@pytest.fixture(scope="module")
def matchers():
    """The tiny LightGlue (float32) with the fused assignment, as each
    package's chunk builds its learned matcher, at this scene's size."""
    jl = JLightGlue(input_dim=D, dtype=jnp.float32, **j_e2e.TINY_LG)
    d8, k8, m8 = jnp.zeros((8, D)), jnp.zeros((8, 2)), jnp.ones((8,), bool)
    jp = j_load(os.path.join(CKPT, "lg_tiny.npz"),
                jax_weights.like(jl, d8, d8, k8, k8, m8, m8))

    def j_match_fn(kpts0, desc0, valid0, kpts1, desc1, valid1):
        f0, f1, z0, z1 = jl.apply(jp, desc0, desc1,
                                  normalize_keypoints(kpts0, H, W),
                                  normalize_keypoints(kpts1, H, W),
                                  valid0, valid1, return_features=True)
        mo = j_asg.fused_assignment(f0, f1, z0, z1, valid0, valid1,
                                    1.0 / float(jl.dim) ** 0.5, 0.0)
        return j_match.MatchResult(matches0=mo.matches0,
                                   mscores0=mo.mscores0)

    tl = LightGlueNet(input_dim=D, dtype=torch.float32, **t_config.TINY_LG)
    ckpt.load_module(tl, os.path.join(CKPT, "lg_tiny.npz"),
                     ckpt.lightglue_state_dict)
    tcfg = t_config.SLAMConfig(frontend=t_config.FrontendConfig(
        image_height=H, image_width=W, max_keypoints=N, descriptor_dim=D))
    return {"mutual-nn": (None, None),
            "lightglue": (j_match_fn, t_fused.build_matcher(tcfg, tl))}


def _seed(jstate):
    """Source (a)'s associations as the passes take them: the previous
    keyframe's map points, on every other keypoint row only, so that the
    other half, which the seeds exclude, stay candidates."""
    last = int(jstate.map.num_kf) - 1
    seed = np.array(jstate.map.kf_kp2mp[last])
    seed[1::2] = -1
    return seed


@pytest.mark.parametrize("matcher", ["mutual-nn", "lightglue"])
@pytest.mark.parametrize("mode", MODES)
def test_one_pass_reobservation_matches_jax(carried, matchers, mode,
                                            matcher):
    """match_unified / match_batched give the JAX ids and candidate counts
    exactly. Every point's last sighting is aged by one keyframe on both
    sides, so that the window pool is not empty (with every frame a
    keyframe, pass 1 re-observes nearly every point; see
    tests/test_torch_pipeline.py)."""
    jstate, tstate, fj, ft, (Kj, Kt) = carried
    jm, tm = matchers[matcher]
    jcfg = with_mode(tp_mod._cfg(j_config), mode)
    tcfg = with_mode(tp_mod._cfg(t_config), mode)
    jmap = jstate.map._replace(pts_last_kf=jstate.map.pts_last_kf - 1)
    tmap = tstate.map._replace(pts_last_kf=tstate.map.pts_last_kf - 1)
    seed = _seed(jstate)
    # a predicted pose a little off the previous one, so that the two
    # projections of the batched mode differ
    c, s = np.cos(np.deg2rad(0.3)), np.sin(np.deg2rad(0.3))
    Rp = (np.asarray(jstate.R_cur)
          @ np.float32([[c, 0, s], [0, 1, 0], [-s, 0, c]])).astype(np.float32)
    tp = (np.asarray(jstate.t_cur)
          + np.float32([0.02, -0.01, 0.05])).astype(np.float32)
    with torch.no_grad():
        if mode == "merged":
            rj = j_reobs.match_unified(jcfg, Kj, jmap, jnp.asarray(Rp),
                                       jnp.asarray(tp), fj,
                                       seed_mpid=jnp.asarray(seed),
                                       matcher=jm)
            rt = t_reobs.match_unified(tcfg, Kt, tmap, torch.from_numpy(Rp),
                                       torch.from_numpy(tp), ft,
                                       seed_mpid=torch.from_numpy(seed),
                                       matcher=tm)
        else:
            rj = j_reobs.match_batched(jcfg, Kj, jmap, jstate.R_cur,
                                       jstate.t_cur, jnp.asarray(Rp),
                                       jnp.asarray(tp), fj,
                                       seed_mpid=jnp.asarray(seed),
                                       matcher=jm)
            rt = t_reobs.match_batched(tcfg, Kt, tmap, tstate.R_cur,
                                       tstate.t_cur, torch.from_numpy(Rp),
                                       torch.from_numpy(tp), ft,
                                       seed_mpid=torch.from_numpy(seed),
                                       matcher=tm)
    np.testing.assert_array_equal(rt.reobs_mpid.numpy(),
                                  np.asarray(rj.reobs_mpid))
    assert int(rt.num_candidates) == int(rj.num_candidates) > 0
    assert int((rt.reobs_mpid >= 0).sum()) > 0


def test_batched_merge_gives_the_window_hit_priority(carried):
    """Where both sets of the batched pass match one keypoint, the window
    hit is written last and wins, as in JAX: the batched result equals
    the covisibility pass's hits overwritten by the window pass's."""
    jstate, tstate, _, ft, (_, Kt) = carried
    tcfg = with_mode(tp_mod._cfg(t_config), "batched")
    tmap = tstate.map._replace(pts_last_kf=tstate.map.pts_last_kf - 1)
    seed = torch.from_numpy(_seed(jstate))
    both = t_reobs.match_batched(tcfg, Kt, tmap, tstate.R_cur, tstate.t_cur,
                                 tstate.R_cur, tstate.t_cur, ft,
                                 seed_mpid=seed)
    win = t_reobs.match_map_window(tcfg, Kt, tmap, tstate.R_cur,
                                   tstate.t_cur, ft)
    cov = t_reobs.match_covisible(tcfg, Kt, tmap, tstate.R_cur,
                                  tstate.t_cur, ft, seed_mpid=seed,
                                  already_mpid=seed)
    want = torch.where(win.reobs_mpid >= 0, win.reobs_mpid, cov.reobs_mpid)
    assert torch.equal(both.reobs_mpid, want)
    # the two pools overlap, so the priority is exercised
    assert int(((win.reobs_mpid >= 0) & (cov.reobs_mpid >= 0)).sum()) > 0


ASSOC = ("num_assoc_prev", "num_assoc_window", "num_assoc_covis")


@pytest.mark.parametrize("mode", MODES)
def test_per_frame_mode_matches_jax(per_frame_runs, scene, mode):
    """Verdicts and association counts per frame equal JAX's; poses within
    tests/test_torch_pipeline.py's tolerances; the bounds of
    test_tracking.py's test of the mode hold."""
    jp, tp = per_frame_runs[mode]
    j, t = tp_mod._outputs(jp), tp_mod._outputs(tp)
    np.testing.assert_array_equal(t["frame_ok"], j["frame_ok"])
    np.testing.assert_array_equal(t["num_matches"], j["num_matches"])
    for name in ASSOC + ("num_map_matches",):
        got = np.stack([np.asarray(getattr(o, name)) for o in tp.outputs])
        ref = np.stack([np.asarray(getattr(o, name)) for o in jp.outputs])
        np.testing.assert_array_equal(got, ref, err_msg=name)
    # one pass: every re-observation counts as source (b)
    assert all(int(o.num_assoc_covis) == 0 for o in tp.outputs[1:])
    np.testing.assert_allclose(t["R"], j["R"], atol=tp_mod.R_TOL)
    np.testing.assert_allclose(t["t"], j["t"], atol=tp_mod.T_TOL)
    R, tt, _ = tp.trajectory()
    errs = t_metrics.per_frame_pose_errors(R, tt, scene.poses_R[:10],
                                           scene.poses_t[:10])
    assert errs.rot_deg.max() < 0.5 and errs.t_mag.max() < 0.15, errs
    c_est = t_metrics.camera_centers(R, tt)
    c_gt = t_metrics.camera_centers(scene.poses_R[:10], scene.poses_t[:10])
    assert t_metrics.ate_rmse(c_est, c_gt, align=False) < 0.08
    assert int(tp.outputs[-1].num_map_matches) > 30
