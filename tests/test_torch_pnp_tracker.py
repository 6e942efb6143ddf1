"""The PnP tracker (`runtime.tracker="pnp"`): the port against JAX.

Under the PnP tracker a frame's pose is predicted as the previous pose, a
PnP RANSAC on the 3D-2D set gives the start of the pose LM and filters the
associations, new points are triangulated between the two map poses, and
no essential RANSAC runs after the bootstrap. Both packages take the same
draws: the JAX key recurrence (bootstrap `split(key)`, then
`key, k_ess, k_pnp = split(key, 3)` per frame) is replayed here, the
bootstrap's `uniform(k_ess, (hypotheses, 8))` through `draws` and each
frame's `gumbel(k_pnp, (pnp_hypotheses, N))` through `pnp_draws`, and the
replays are used up exactly. Two routes: TrackingPipeline over
tests/test_tracking.py's scene (10 frames, BA off), held to
tests/test_torch_pipeline.py's tolerances and to the bounds of
test_tracking.py::test_tracking_pnp_mode; and the chunked learned tracker
on tests/test_torch_slice.py's 240x320 scene (bootstrap plus one chunk of
8), held to that file's tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu import config as j_config
from gl_slam_tpu.io import synthetic
from gl_slam_tpu.slam import fused as j_fused
from gl_slam_tpu.slam.chunk_driver import ChunkedPipeline as JChunked
from gl_slam_tpu.slam.pipeline import TrackingPipeline as JPipeline
from gl_slam_tpu.train import e2e as j_e2e
from gl_slam_tpu_torch import config as t_config
from gl_slam_tpu_torch import metrics as t_metrics
from gl_slam_tpu_torch.slam.pipeline import TrackingPipeline
from gl_slam_tpu_torch.train import e2e as t_e2e

import test_torch_pipeline as tp_mod
import test_torch_slice as ts_mod
import jax_weights

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

N_FRAMES = 10


def pnp_cfg(cfg):
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, tracker="pnp"))


def jax_pnp_draws(seed, hypotheses, pnp_hypotheses, n_kpts, n_frames):
    """(bootstrap essential draws (hypotheses, 8), per-frame PnP Gumbels
    (pnp_hypotheses, n_kpts) for the n_frames - 2 tracked frames) of the
    JAX key recurrence from PRNGKey(seed)."""
    key, k_ess = jax.random.split(jax.random.PRNGKey(seed))
    boot = np.asarray(jax.random.uniform(k_ess, (hypotheses, 8)))
    gumbels = []
    for _ in range(n_frames - 2):
        key, _, k_pnp = jax.random.split(key, 3)
        gumbels.append(np.asarray(jax.random.gumbel(
            k_pnp, (pnp_hypotheses, n_kpts))))
    return boot, gumbels


def feeder(arrays):
    """(feed, consumed): feed(n) hands out the next n arrays stacked."""
    pos = [0]

    def feed(n):
        out = np.stack(arrays[pos[0]:pos[0] + n])
        pos[0] += n
        return torch.from_numpy(out)

    return feed, pos


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(num_landmarks=3000, num_frames=16,
                                height=tp_mod.H, width=tp_mod.W,
                                desc_dim=tp_mod.D, seed=42)


@pytest.fixture(scope="module")
def per_frame(scene):
    """(JAX pipeline, port pipeline) after N_FRAMES frames, BA off."""
    obs = [synthetic.observe_frame(scene, i, max_keypoints=tp_mod.N, seed=9)
           for i in range(N_FRAMES)]
    jcfg = pnp_cfg(tp_mod._cfg(j_config))
    jp = JPipeline(jcfg, scene.K, enable_ba=False)
    tp_mod._drive(jp, scene, obs)
    boot, gumbels = jax_pnp_draws(jcfg.runtime.seed,
                                  jcfg.geometry.essential_hypotheses,
                                  jcfg.geometry.pnp_hypotheses, tp_mod.N,
                                  N_FRAMES)
    tp = TrackingPipeline(pnp_cfg(tp_mod._cfg(t_config)), scene.K,
                          enable_ba=False, device="cpu", draws=[boot],
                          pnp_draws=gumbels)
    tp_mod._drive(tp, scene, obs)
    # the bootstrap's essential draws, then one PnP draw set per step
    assert next(tp._draws, None) is None
    assert next(tp._pnp_draws, None) is None
    return jp, tp


def test_per_frame_pnp_matches_jax(per_frame):
    jp, tp = per_frame
    j, t = tp_mod._outputs(jp), tp_mod._outputs(tp)
    assert len(tp.outputs) == len(jp.outputs) == N_FRAMES - 1
    np.testing.assert_array_equal(t["frame_ok"], j["frame_ok"])
    assert t["frame_ok"].all()
    np.testing.assert_array_equal(t["num_matches"], j["num_matches"])
    # no essential RANSAC: the inlier count is the pair count
    np.testing.assert_array_equal(t["num_inliers"][1:], t["num_matches"][1:])
    for name in ("num_map_matches", "num_assoc_prev", "num_assoc_window",
                 "num_assoc_covis", "num_new_points"):
        got = np.stack([np.asarray(getattr(o, name)) for o in tp.outputs])
        ref = np.stack([np.asarray(getattr(o, name)) for o in jp.outputs])
        np.testing.assert_array_equal(got, ref, err_msg=name)
    for o in tp.outputs[1:]:
        assert float(o.dbg_s_lm) == float(o.dbg_step_ratio) == 0.0
    np.testing.assert_allclose(t["R"], j["R"], atol=tp_mod.R_TOL)
    np.testing.assert_allclose(t["t"], j["t"], atol=tp_mod.T_TOL)


def test_per_frame_pnp_tracks_within_the_jax_bounds(per_frame, scene):
    """test_tracking.py::test_tracking_pnp_mode's bounds on the port."""
    _, tp = per_frame
    R, t, fidx = tp.trajectory()
    assert len(R) == N_FRAMES and list(fidx) == list(range(N_FRAMES))
    errs = t_metrics.per_frame_pose_errors(R, t, scene.poses_R[:N_FRAMES],
                                           scene.poses_t[:N_FRAMES])
    assert errs.rot_deg.max() < 0.5, errs.rot_deg
    assert errs.t_mag.max() < 0.15, errs.t_mag


def test_pnp_step_needs_its_draws(per_frame):
    """A PnP step without Gumbel draws raises instead of running another
    tracker."""
    from gl_slam_tpu_torch.slam import frontend as t_frontend
    _, tp = per_frame
    f = tp._features(np.zeros((tp_mod.N, 2), np.float32),
                     np.zeros((tp_mod.N, tp_mod.D), np.float32),
                     np.zeros(tp_mod.N, bool), 99)
    with pytest.raises(ValueError, match="pnp_gumbel"):
        t_frontend.track_step(tp.cfg, tp.K, tp.state, f, None)


NF_CHUNKED = 2 + ts_mod.CHUNK
# Under the PnP tracker each pose rests on the map alone, and a new point
# whose depth or reprojection sits on its gate may fall either side under
# another summation order; the maps then differ by a point and the poses
# part by up to ~2 cm over this chunk. The JAX package shows the same
# sensitivity: moving its bootstrap scale by 1e-5 relative flips the same
# point at frame 4 and gives the trajectory the port gives (measured). So
# the port is held, within tests/test_torch_slice.py's first-chunk
# tolerances, to the JAX run or to that nudged JAX run.
SCALE_NUDGES = (0.0, 1e-5)


@pytest.fixture(scope="module")
def chunked():
    """The JAX ChunkedPipeline's and the port's per-frame outputs over a
    bootstrap plus one chunk of 8 of tests/test_torch_slice.py's scene,
    BA off."""
    scene, stack, scale = ts_mod._scene()
    sp, spp, lg, lgp = jax_weights.load_tiny_frontend(ts_mod.CKPT)
    jcfg = pnp_cfg(ts_mod._backend(j_e2e.micro_config(
        ts_mod.H, ts_mod.W, ts_mod.N, j_e2e.TINY_DESC_DIM), False))
    refs = []
    for s in SCALE_NUDGES:
        jp = JChunked(jcfg, jnp.asarray(scene.K, jnp.float32),
                      sp.clone(dtype=jnp.float32),
                      lg.clone(dtype=jnp.float32),
                      j_fused.FusedParams(sp=spp, lg=lgp),
                      chunk=ts_mod.CHUNK, enable_ba=False)
        jp.bootstrap_from_images(stack[0], stack[1], scale * (1.0 + s))
        jp.track_chunk(jnp.asarray(stack[2:NF_CHUNKED]), 2)
        refs.append(jp.stacked_outputs())

    boot, gumbels = jax_pnp_draws(0, jcfg.geometry.essential_hypotheses,
                                  jcfg.geometry.pnp_hypotheses, ts_mod.N,
                                  NF_CHUNKED)
    feed, pos = feeder([boot])
    pnp_feed, pnp_pos = feeder(gumbels)
    tsp, tlg = t_e2e.load_tiny_frontend(ts_mod.CKPT, device="cpu",
                                        dtype=torch.float32)
    tcfg = pnp_cfg(ts_mod._backend(t_config.micro_config(
        ts_mod.H, ts_mod.W, ts_mod.N, t_config.TINY_DESC_DIM), False))
    diag = {}
    res = t_e2e.run_learned_e2e(tsp, tlg, scene, tcfg, NF_CHUNKED,
                                chunk=ts_mod.CHUNK, device="cpu", draws=feed,
                                pnp_draws=pnp_feed, stack=stack[:NF_CHUNKED],
                                diag_out=diag)
    assert pos[0] == 1 and pnp_pos[0] == NF_CHUNKED - 2
    return refs, diag["outputs"], res


def test_chunked_pnp_matches_jax(chunked):
    refs, got, res = chunked
    for ref in refs:
        np.testing.assert_array_equal(got.frame_ok, ref.frame_ok)
        np.testing.assert_array_equal(got.num_matches, ref.num_matches)
    np.testing.assert_array_equal(got.num_inliers, got.num_matches)

    def agrees(ref):
        """tests/test_torch_slice.py's first-chunk tolerances: poses to
        1e-3, threshold decisions at most 2 per frame in few frames."""
        d = np.abs(got.num_map_matches.astype(int)
                   - ref.num_map_matches.astype(int))
        return (d.max() <= 2 and (d > 0).sum() <= 2
                and np.abs(got.R - ref.R).max() <= 1e-3
                and np.abs(got.t - ref.t).max() <= 1e-3)

    assert any(agrees(ref) for ref in refs), [
        (np.abs(got.t - ref.t).max(), ref.num_map_matches) for ref in refs]
    assert res.num_keyframes == NF_CHUNKED and res.num_rejected == 0
    assert res.ate_m < 1.0, res
