"""The per-frame route's TrackingPipeline: the port against the JAX package.

The scene and front end of tests/test_tracking.py: the 240x320 synthetic
scene (3000 landmarks, seed 42), oracle features (N=256, D=64, observation
seed 9), its configuration (128 essential hypotheses, window BA of 12
cameras). Both packages take the same RANSAC draws: the JAX pipeline's key
recurrence (bootstrap `split(key)`, then `split(key, 3)` per frame) is
replayed here and each `uniform(k_ess, (hypotheses, 8))` is fed to the
port through `draws`. Three runs each: BA off over 10 frames, async BA
(trigger 4) over 14 frames with 0.25 px noise, sync BA over the same; then
the health check's rollback after an injected NaN, the two mutual-NN
re-observation passes on the JAX pipeline's map, and the loop checks'
cadence (their Gumbel draws replayed from the JAX keys through
`loop_draws`). Both sides run in float32 at "highest" matmul precision
(tests/conftest.py).
"""

import numpy as np
import pytest
import torch

import jax

from gl_slam_tpu import config as j_config
from gl_slam_tpu.io import synthetic
from gl_slam_tpu.slam import frontend as j_frontend
from gl_slam_tpu.slam import reobserve as j_reobs
from gl_slam_tpu.slam.pipeline import TrackingPipeline as JPipeline
from gl_slam_tpu_torch import config as t_config
from gl_slam_tpu_torch.slam import frontend as t_frontend
from gl_slam_tpu_torch.slam import reobserve as t_reobs
from gl_slam_tpu_torch.slam.pipeline import TrackingPipeline

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

H, W, N, D = 240, 320, 256, 64


def _cfg(c, **runtime):
    """test_tracking.make_cfg(), built from either package's config
    module, with `runtime` overrides."""
    return c.SLAMConfig(
        frontend=c.FrontendConfig(image_height=H, image_width=W,
                                  max_keypoints=N, descriptor_dim=D),
        geometry=c.GeometryConfig(essential_hypotheses=128,
                                  essential_refine_iters=5,
                                  triangulation_reproj_px=0.5),
        ba=c.BAConfig(max_window_cameras=12, max_window_points=2048,
                      full_ba_iters=15, pose_only_iters=15),
        map=c.MapConfig(max_keyframes=64, max_points=8192,
                        covis_max_points=256, covis_edge_threshold=10),
        runtime=c.RuntimeConfig(**runtime))


def jax_draws(cfg, n_steps):
    """The JAX pipeline's RANSAC draws, one (hypotheses, 8) array for the
    bootstrap and for each of `n_steps - 1` tracked frames."""
    hyp = cfg.geometry.essential_hypotheses
    key, k_ess = jax.random.split(jax.random.PRNGKey(cfg.runtime.seed))
    draws = [np.asarray(jax.random.uniform(k_ess, (hyp, 8)))]
    for _ in range(n_steps - 1):
        key, k_ess, _ = jax.random.split(key, 3)
        draws.append(np.asarray(jax.random.uniform(k_ess, (hyp, 8))))
    return draws


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(num_landmarks=3000, num_frames=16, height=H,
                                width=W, desc_dim=D, seed=42)


def _drive(pipe, scene, obs):
    """Bootstrap and step through `obs`; records after each step whether a
    BA result waits to be folded (`pipe.in_flight`)."""
    c0 = -scene.poses_R[0].T @ scene.poses_t[0]
    c1 = -scene.poses_R[1].T @ scene.poses_t[1]
    pipe.bootstrap((obs[0].keypoints, obs[0].descriptors, obs[0].valid, 0),
                   (obs[1].keypoints, obs[1].descriptors, obs[1].valid, 1),
                   gt_scale=float(np.linalg.norm(c1 - c0)))
    pipe.in_flight = []
    for i in range(2, len(obs)):
        pipe.step(obs[i].keypoints, obs[i].descriptors, obs[i].valid, i)
        pipe.in_flight.append(pipe._inflight_ba is not None)
    pipe.block()


def jax_loop_draws(cfg, n):
    """The JAX pipeline's loop-detection draws over n frames: at each check
    (after the step that makes `len(outputs)` = k, k > loop_min_gap, k a
    multiple of loop_check_interval) the key PRNGKey(k), split over the 4
    regions of `detect_loop`'s mutual-NN path, each a Gumbel (PnP
    hypotheses, sampled map points) draw; every slot is sampled below 8192
    slots."""
    rt = cfg.runtime
    shape = (cfg.geometry.pnp_hypotheses, min(cfg.map.max_points, 8192))
    return [np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, shape))(
        jax.random.split(jax.random.PRNGKey(k), 4)))
        for k in range(rt.loop_min_gap + 1, n)
        if k % rt.loop_check_interval == 0]


def _both(scene, n, noise_px=0.0, enable_ba=True, **runtime):
    """(JAX pipeline, port pipeline) after the same n frames."""
    obs = [synthetic.observe_frame(scene, i, max_keypoints=N,
                                   noise_px=noise_px, seed=9)
           for i in range(n)]
    jcfg = _cfg(j_config, **runtime)
    jp = JPipeline(jcfg, scene.K, enable_ba=enable_ba)
    _drive(jp, scene, obs)
    draws = jax_draws(jcfg, n - 1)
    tp = TrackingPipeline(_cfg(t_config, **runtime), scene.K,
                          enable_ba=enable_ba, device="cpu", draws=draws,
                          loop_draws=jax_loop_draws(jcfg, n))
    _drive(tp, scene, obs)
    assert next(tp._draws, None) is None     # one draw set per step
    assert next(tp._loop_draws, None) is None    # one per loop check
    return jp, tp


def _outputs(pipe):
    """Per-step (R, t, num_matches, num_inliers, frame_ok) as numpy."""
    def col(name):
        return np.stack([np.asarray(getattr(o, name)) for o in pipe.outputs])
    return {k: col(k) for k in ("R", "t", "num_matches", "num_inliers",
                                "num_map_matches", "frame_ok")}


@pytest.fixture(scope="module")
def runs(scene):
    return {"no_ba": _both(scene, 10, enable_ba=False),
            "async": _both(scene, 14, noise_px=0.25, async_ba=True,
                           ba_trigger_keyframes=4),
            "sync": _both(scene, 14, noise_px=0.25, async_ba=False,
                          ba_trigger_keyframes=4)}


# Tolerances: float32 on both sides with other summation orders. Over
# these runs the per-frame rotations agree to ~1e-5 and the translations
# to ~1e-4 m (steps of ~1 m); the bounds leave an order of magnitude.
# Mutual-NN matches and the frame verdicts are exact; an essential inlier
# on the Sampson threshold may fall either way (at most 2 per frame).
R_TOL, T_TOL = 2e-4, 2e-3


@pytest.mark.parametrize("run", ["no_ba", "async", "sync"])
def test_pipeline_poses_and_counts_match_jax(runs, run):
    jp, tp = runs[run]
    j, t = _outputs(jp), _outputs(tp)
    assert len(tp.outputs) == len(jp.outputs)
    np.testing.assert_array_equal(t["frame_ok"], j["frame_ok"])
    np.testing.assert_array_equal(t["num_matches"], j["num_matches"])
    d = np.abs(t["num_inliers"].astype(int) - j["num_inliers"].astype(int))
    assert d.max() <= 2, (t["num_inliers"], j["num_inliers"])
    dm = np.abs(t["num_map_matches"].astype(int)
                - j["num_map_matches"].astype(int))
    assert dm.max() <= 3, (t["num_map_matches"], j["num_map_matches"])
    np.testing.assert_allclose(t["R"], j["R"], atol=R_TOL)
    np.testing.assert_allclose(t["t"], j["t"], atol=T_TOL)


@pytest.mark.parametrize("run", ["no_ba", "async", "sync"])
def test_pipeline_trajectory_and_map_match_jax(runs, run):
    """The keyframe trajectory after folding the last async BA, and the
    map's counts: keyframes and BA runs exact, points within 1 %."""
    jp, tp = runs[run]
    Rj, tj, fj = jp.trajectory()
    Rt, tt, ft = tp.trajectory()
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(Rt, Rj, atol=R_TOL)
    np.testing.assert_allclose(tt, tj, atol=T_TOL)
    sj, st = jp.map_stats(), tp.map_stats()
    for k in ("num_keyframes", "num_ba_runs"):
        assert st[k] == sj[k], (k, st, sj)
    for k in ("num_points", "num_good_points"):
        assert abs(st[k] - sj[k]) <= 0.01 * sj[k], (k, st, sj)
    if run != "no_ba":
        assert st["num_ba_runs"] >= 2


def test_async_ba_folds_one_step_late(runs):
    """An async BA pass waits after its trigger step and is folded at the
    start of the next, as in JAX (12 steps, trigger 4: passes after steps
    4, 8 and 12); a sync pass never waits."""
    ja, ta = runs["async"]
    js, ts = runs["sync"]
    assert ta.in_flight == ja.in_flight
    assert ta.in_flight == [i % 4 == 3 for i in range(12)]
    assert ts.in_flight == js.in_flight == [False] * 12


def test_health_check_rolls_back_like_jax(runs):
    """A NaN pose rolls both pipelines back to the last snapshot that
    passed, at the next BA trigger (tests/test_async_ba.py's injection)."""
    jp, tp = runs["sync"]
    snap_j = np.asarray(jp._last_good.t_cur)
    snap_t = tp._last_good.t_cur.numpy().copy()
    np.testing.assert_allclose(snap_t, snap_j, atol=T_TOL)
    jp.state = jp.state._replace(t_cur=jax.numpy.full((3,), np.nan,
                                                      np.float32))
    tp.state = tp.state._replace(t_cur=torch.full((3,), float("nan")))
    for p in (jp, tp):
        p._steps_since_check = p.cfg.runtime.ba_trigger_keyframes
        p._maybe_ba()
    assert tp.num_recoveries == jp.num_recoveries == 1
    np.testing.assert_array_equal(tp.state.t_cur.numpy(), snap_t)
    assert tp.state is tp._last_good


@pytest.fixture(scope="module")
def carried(runs, scene):
    """The JAX no-BA pipeline's state after frames 0-9, carried to the
    port, frame 10's features and K, in both packages."""
    jp, _ = runs["no_ba"]
    jstate = jp.state
    tstate = t_frontend.track_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate))
    o = synthetic.observe_frame(scene, 10, max_keypoints=N, seed=9)
    fj = j_frontend.FrameFeatures(
        kpts=jax.numpy.asarray(o.keypoints, np.float32),
        desc=jax.numpy.asarray(o.descriptors, np.float32),
        valid=jax.numpy.asarray(o.valid), frame_idx=jax.numpy.int32(10))
    ft = t_frontend.FrameFeatures(
        torch.from_numpy(np.asarray(o.keypoints, np.float32)),
        torch.from_numpy(np.asarray(o.descriptors, np.float32)),
        torch.from_numpy(np.asarray(o.valid)), torch.tensor(10))
    K = np.asarray(scene.K, np.float32)
    return jstate, tstate, fj, ft, (jax.numpy.asarray(K),
                                    torch.from_numpy(K))


def test_mutual_nn_reobservation_passes_match_jax(carried):
    """`match_map_window` and `match_covisible` without a matcher (the
    oracle and Harris routes' re-observation) give the JAX ids exactly."""
    jstate, tstate, fj, ft, (Kj, Kt) = carried
    jcfg, tcfg = _cfg(j_config), _cfg(t_config)
    # With every frame a keyframe and stable oracle descriptors, pass 1
    # re-observes nearly every point, so almost none was last seen before
    # the previous keyframe (the window pass's candidates). Aging every
    # point's last sighting by one keyframe, on both sides, makes the
    # previous keyframe's points candidates too.
    jmap = jstate.map._replace(pts_last_kf=jstate.map.pts_last_kf - 1)
    tmap = tstate.map._replace(pts_last_kf=tstate.map.pts_last_kf - 1)
    rj = j_reobs.match_map_window(jcfg, Kj, jmap, jstate.R_cur,
                                  jstate.t_cur, fj, None, None)
    rt = t_reobs.match_map_window(tcfg, Kt, tmap, tstate.R_cur,
                                  tstate.t_cur, ft)
    np.testing.assert_array_equal(rt.reobs_mpid.numpy(),
                                  np.asarray(rj.reobs_mpid))
    assert int(rt.num_candidates) == int(rj.num_candidates) > 0
    assert int((rt.reobs_mpid >= 0).sum()) > 0
    # covisibility retrieval seeded by the previous keyframe's map points
    last = int(jstate.map.num_kf) - 1
    seed = np.array(jstate.map.kf_kp2mp[last])
    cj = j_reobs.match_covisible(jcfg, Kj, jstate.map, jstate.R_cur,
                                 jstate.t_cur, fj,
                                 seed_mpid=jax.numpy.asarray(seed),
                                 already_mpid=rj.reobs_mpid)
    ct = t_reobs.match_covisible(tcfg, Kt, tstate.map, tstate.R_cur,
                                 tstate.t_cur, ft,
                                 seed_mpid=torch.from_numpy(seed),
                                 already_mpid=rt.reobs_mpid)
    np.testing.assert_array_equal(ct.reobs_mpid.numpy(),
                                  np.asarray(cj.reobs_mpid))
    assert int(ct.num_candidates) == int(cj.num_candidates) > 0


def test_track_step_matches_jax_on_a_carried_state(carried):
    """One standalone `track_step` (mutual-NN pass 1 and the essential
    RANSAC inside the step, on the JAX key's draws) from the JAX map."""
    jstate, tstate, fj, ft, (Kj, Kt) = carried
    jcfg, tcfg = _cfg(j_config), _cfg(t_config)
    _, k_ess, _ = jax.random.split(jstate.key, 3)
    u = np.asarray(jax.random.uniform(k_ess, (128, 8)))
    sj, oj = j_frontend.track_step(jcfg, Kj, jstate, fj)
    st, ot = t_frontend.track_step(tcfg, Kt, tstate, ft, torch.from_numpy(u))
    for name in ("num_matches", "num_inliers", "num_map_matches",
                 "num_new_points", "frame_ok"):
        assert int(getattr(ot, name)) == int(getattr(oj, name)), name
    np.testing.assert_allclose(ot.R.numpy(), np.asarray(oj.R), atol=R_TOL)
    np.testing.assert_allclose(ot.t.numpy(), np.asarray(oj.t), atol=T_TOL)
    assert int(st.map.num_kf) == int(sj.map.num_kf)


def test_loop_checks_run_on_the_jax_cadence(scene, monkeypatch):
    """With loop closing on and a short gap (checks after the steps that
    make 6 and 9 outputs), both pipelines run a detection at the same
    steps on the JAX key's draws, for the same current keyframe, with the
    same verdict; the scene moves forward, so no loop verifies."""
    from gl_slam_tpu.slam import loopclose as j_lc
    from gl_slam_tpu_torch.slam import loopclose as t_lc
    seen = {"jax": [], "port": []}

    def spy(side, detect):
        def wrapped(*args, **kw):
            det = detect(*args, **kw)
            seen[side].append(tuple(int(np.asarray(getattr(det, name)))
                                    for name in ("ok", "cur_kf")))
            return det
        return wrapped

    monkeypatch.setattr(j_lc, "detect_loop", spy("jax", j_lc.detect_loop))
    monkeypatch.setattr(t_lc, "detect_loop", spy("port", t_lc.detect_loop))
    jp, tp = _both(scene, 10, enable_ba=False, loop_closing=True,
                   loop_min_gap=5, loop_check_interval=3)
    assert seen["port"] == seen["jax"], seen
    assert [ok for ok, _ in seen["jax"]] == [0, 0]
    assert tp.loop_closures == getattr(jp, "loop_closures", 0) == 0
    j, t = _outputs(jp), _outputs(tp)
    np.testing.assert_array_equal(t["num_matches"], j["num_matches"])
    np.testing.assert_allclose(t["t"], j["t"], atol=T_TOL)
