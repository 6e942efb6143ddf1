"""Loop closing on the chunked driver: the port against JAX, and against
itself with loop closing off.

The micro pipeline of tests/test_torch_slice.py (committed tiny weights,
the 240x320, N=128, 900-landmark scene, window BA every 8 frames) over a
bootstrap plus three chunks of 8, with loop closing on and the cadence
lowered so that three checks run (after frames 10, 18 and 26: past a
4-frame gap, every 8 frames). Both packages take the same draws: the JAX
key recurrence of the essential RANSAC (as in test_torch_slice.py) and
each detection's PnP Gumbel draws from `PRNGKey(frames)`, fed to the port
through `loop_draws`.

No closure fires by itself at this size in either package: the tiny
matcher leaves ~25 database matches per candidate with under half of them
inliers, and no 6-point sample of 512 verifies. So the first detection's
verdict is forced on both sides (ok, revisiting keyframe 1 at the ground
truth pose of the frame it ran on) and the closure, applied one interval
later, is compared as well.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu.io import synthetic
from gl_slam_tpu.slam import fused as j_fused
from gl_slam_tpu.slam.chunk_driver import ChunkedPipeline as JPipeline
from gl_slam_tpu.train import e2e as j_e2e
from gl_slam_tpu_torch import config as t_cfg
from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline
from gl_slam_tpu_torch.train import e2e as t_e2e
from gl_slam_tpu_torch.train import evals as t_evals

import jax_weights

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
H, W, N, NF, CHUNK = 240, 320, 128, 26, 8
D = j_e2e.TINY_DESC_DIM
CHECKS = [10, 18, 26]          # frame counts at the three loop checks
FORCED_LOOP_KF = 1


def _cfg(c, loop):
    cfg = c.micro_config(H, W, N, D)
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, run_full_ba=True, loop_closing=loop, loop_min_gap=4,
        loop_check_interval=8))


def _essential_draws(cfg):
    """The JAX driver's RANSAC draws: bootstrap `split(key)`, then
    `split(key, 3)` per frame."""
    hyp = cfg.geometry.essential_hypotheses
    key, k_ess = jax.random.split(jax.random.PRNGKey(0))
    draws = [np.asarray(jax.random.uniform(k_ess, (hyp, 8)))]
    for _ in range(NF - 2):
        key, k_ess, _ = jax.random.split(key, 3)
        draws.append(np.asarray(jax.random.uniform(k_ess, (hyp, 8))))
    return draws


def _feeder(draws):
    pos = [0]

    def feed(n):
        out = np.stack(draws[pos[0]:pos[0] + n])
        pos[0] += n
        return torch.from_numpy(out)

    return feed


def _loop_draws(cfg):
    """The JAX detection's PnP draws at frame count `frames`:
    `split(PRNGKey(frames), Q)`, one Gumbel (hypotheses, Kdb) each."""
    Q = cfg.runtime.loop_candidates
    shape = (cfg.geometry.pnp_hypotheses, min(cfg.map.loop_db_keypoints, N))

    def draws(frames):
        keys = jax.random.split(jax.random.PRNGKey(frames), Q)
        return torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.gumbel(k, shape, jnp.float32))(keys)))

    return draws


def _forced(det, scene, frames, to_device):
    """`det` with its verdict forced: ok, the revisit of keyframe 1 at the
    ground truth pose of frame frames - 1 (the carried frame)."""
    return det._replace(ok=to_device(np.asarray(True)),
                        loop_kf=to_device(np.asarray(FORCED_LOOP_KF,
                                                     np.int32)),
                        R=to_device(scene.poses_R[frames - 1]
                                    .astype(np.float32)),
                        t=to_device(scene.poses_t[frames - 1]
                                    .astype(np.float32)))


@pytest.fixture(scope="module")
def scene_stack():
    scene = synthetic.make_scene(num_landmarks=900, num_frames=NF,
                                 height=H, width=W, desc_dim=D, seed=11)
    stack = t_e2e.render_stack(scene, NF, N)
    c0 = -scene.poses_R[0].T @ scene.poses_t[0]
    c1 = -scene.poses_R[1].T @ scene.poses_t[1]
    return scene, stack, float(np.linalg.norm(c1 - c0))


@pytest.fixture(scope="module")
def forced_runs(scene_stack):
    """One run of each package with the first verdict forced: (JAX
    pipeline, JAX detections, port pipeline, port detections), each
    detection recorded as the detector returned it."""
    scene, stack, scale = scene_stack
    sp, spp, lg, lgp = jax_weights.load_tiny_frontend(CKPT)
    cfg = _cfg(j_e2e, True)
    jp = JPipeline(cfg, jnp.asarray(scene.K, jnp.float32),
                   sp.clone(dtype=jnp.float32), lg.clone(dtype=jnp.float32),
                   j_fused.FusedParams(sp=spp, lg=lgp), chunk=CHUNK,
                   ba_every=CHUNK)
    j_dets = []
    j_dispatch = jp._dispatch_detect

    def j_record(key):
        det = j_dispatch(key)
        j_dets.append((jp._frames, det))
        if len(j_dets) == 1:
            det = _forced(det, scene, jp._frames, jnp.asarray)
        return det

    jp._dispatch_detect = j_record
    jp.bootstrap_from_images(stack[0], stack[1], scale)
    for s in range(2, NF, CHUNK):
        jp.track_chunk(jnp.asarray(stack[s:s + CHUNK]), s)

    tcfg = _cfg(t_cfg, True)
    tsp, tlg = t_e2e.load_tiny_frontend(CKPT, device="cpu",
                                        dtype=torch.float32)
    tp = ChunkedPipeline(tcfg, scene.K, tsp, tlg, chunk=CHUNK,
                         ba_every=CHUNK, device="cpu",
                         draws=_feeder(_essential_draws(cfg)),
                         loop_draws=_loop_draws(tcfg))
    t_dets = []
    t_detect = tp._detect_fn

    def t_record(st, gumbel):
        det = t_detect(st, gumbel)
        t_dets.append((tp._frames, det))
        if len(t_dets) == 1:
            det = _forced(det, scene, tp._frames, torch.from_numpy)
        return det

    tp._detect_fn = t_record
    tp.bootstrap_from_images(stack[0], stack[1], scale)
    frames = torch.from_numpy(stack)
    for s in range(2, NF, CHUNK):
        tp.track_chunk(frames[s:s + CHUNK], s)
    return jp, j_dets, tp, t_dets


def test_driver_checks_at_the_cadence_like_jax(forced_runs):
    jp, j_dets, tp, t_dets = forced_runs
    assert [f for f, _ in j_dets] == [f for f, _ in t_dets] == CHECKS
    assert [c["frames"] for c in tp.loop_checks] == CHECKS
    assert t_evals.loop_checks_implied(tp.cfg, NF, CHUNK) == CHECKS


@pytest.mark.parametrize("check", range(len(CHECKS)),
                         ids=[f"frame-{f}" for f in CHECKS])
def test_driver_detection_like_jax(forced_runs, check):
    """Each check's detection as the detector returned it: the verdict and
    the counters equal; the pose where the detection holds. The checks
    after the first run on maps that the forced closure corrected on each
    side."""
    _, j_dets, _, t_dets = forced_runs
    dj, dt = j_dets[check][1], t_dets[check][1]
    for name in ("ok", "cur_kf", "n_vis", "n_good", "region_votes",
                 "n_cons", "pnp_raw_ok"):
        assert int(getattr(dt, name)) == int(getattr(dj, name)), name
    if bool(dj.ok):
        assert int(dt.loop_kf) == int(dj.loop_kf)
        assert int(dt.num_inliers) == int(dj.num_inliers)
        np.testing.assert_allclose(dt.R.numpy(), np.asarray(dj.R), atol=1e-3)
        np.testing.assert_allclose(dt.t.numpy(), np.asarray(dj.t), atol=5e-2)


def test_driver_applies_the_closure_like_jax(forced_runs):
    """The forced verdict of the check after frame 10 is read after frame
    18 and attached to the keyframe that was newest at detection."""
    jp, _, tp, _ = forced_runs
    assert tp.num_loop_closures == jp.num_loop_closures == 1
    keys = ("applied_at_frame", "detected_at_kf", "loop_kf", "pnp_inliers")
    assert [{k: e[k] for k in keys} for e in tp.loop_events] \
        == jp.loop_events
    assert tp.loop_events[0]["applied_at_frame"] == CHECKS[1]
    assert tp.loop_events[0]["detected_at_kf"] == CHECKS[0] - 1
    assert tp.num_ba_runs == jp.num_ba_runs == 3
    assert tp.num_recoveries == jp.num_recoveries == 0


def test_driver_trajectory_after_the_closure_like_jax(forced_runs,
                                                      scene_stack):
    jp, _, tp, _ = forced_runs
    # within test_torch_slice.py's tolerances (float32 in both frameworks,
    # other summation orders)
    jR, jt, jidx = jp.trajectory()
    tR, tt, tidx = tp.trajectory()
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_allclose(tR, jR, atol=1e-3)
    np.testing.assert_allclose(tt, jt, atol=5e-2)
    # the closure pulled the detection keyframe to its measured pose
    k = CHECKS[0] - 1
    assert np.linalg.norm(tt[k] - scene_stack[0].poses_t[k]) < 5e-2


@pytest.fixture(scope="module")
def off_and_on(scene_stack):
    """The port's run with loop closing off and with it on, no verdict
    forced (none holds at this size), on the same draws: ((result, diag)
    off, (result, diag) on)."""
    scene, stack, _ = scene_stack
    sp, lg = t_e2e.load_tiny_frontend(CKPT, device="cpu",
                                      dtype=torch.float32)
    runs = []
    for loop in (False, True):
        diag = {}
        res = t_e2e.run_learned_e2e(sp, lg, scene, _cfg(t_cfg, loop), NF,
                                    chunk=CHUNK, ba_every=CHUNK,
                                    device="cpu", seed=3, stack=stack,
                                    diag_out=diag)
        runs.append((res, diag))
    return runs


def test_loop_checks_without_a_closure_run(off_and_on):
    (off, d_off), (on, d_on) = off_and_on
    assert [c["frames"] for c in d_on["loop_checks"]] == CHECKS
    assert not any(bool(c["det"].ok) for c in d_on["loop_checks"])
    assert on.loop_closures == off.loop_closures == 0
    assert d_off["loop_checks"] == []


def test_loop_checks_without_a_closure_change_nothing(off_and_on):
    """The loop-on run equals the loop-off run bit for bit: results,
    per-frame outputs and final state."""
    (off, d_off), (on, d_on) = off_and_on
    assert on._replace(fps=0.0) == off._replace(fps=0.0)
    for a, b in zip(d_on["outputs"], d_off["outputs"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(d_on["state"].map, d_off["state"].map):
        assert torch.equal(a, b)
    for a, b in zip(d_on["state"][1:], d_off["state"][1:]):
        assert (a is None and b is None) or torch.equal(a, b)
