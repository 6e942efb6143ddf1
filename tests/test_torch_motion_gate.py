"""Motion-gated keyframing (`every_frame_keyframe=False`): the port against
JAX, on the per-frame route.

With the reference's every-frame override off, a frame becomes a keyframe
only when it moved more than `gt_mag_filter` metres or turned more than
`gt_rot_filter` degrees since the last keyframe; a rejected frame leaves
the state as it was. TrackingPipeline runs on tests/test_flags.py's
120x160 scene and configuration, on the JAX key recurrence's RANSAC
draws: the two cases of test_flags.py::test_every_frame_keyframe_flag
(filters at 1e6: only the bootstrap pair; at 1e-6: every frame), one that
keeps every third frame, and the lock-out of a filter between one and two
frame steps (below). The `frame_ok` sequences equal JAX's. The chunked
route, with its recovery branch, is in
tests/test_torch_motion_gate_chunked.py.

The partial case keeps every third frame by translation (a 2.5 m filter on
~1 m steps: rejected frames lie 1 and 2 m from the last keyframe, kept ones
3 m, each 0.5 m clear of the filter) with the rotation filter and the
step-ratio check (`pose_step_max_ratio` 1.0) off, so that no decision sits
on a threshold: with the check on, the first frame after a rejection is a
~2 m step against the carried ~1 m, on the check's bound of 2.
"""

import numpy as np
import pytest
import torch

from gl_slam_tpu import config as j_config
from gl_slam_tpu.io import synthetic
from gl_slam_tpu.slam.pipeline import TrackingPipeline as JPipeline
from gl_slam_tpu_torch import config as t_config
from gl_slam_tpu_torch.slam.pipeline import TrackingPipeline

import test_torch_pipeline as tp_mod

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

FH, FW, FN, FD = 120, 160, 96, 32           # tests/test_flags.py's sizes
KEEP_THIRD = dict(gt_mag_filter=2.5, gt_rot_filter=1e6,
                  pose_step_max_ratio=1.0)


def flags_cfg(c, **runtime):
    """tests/test_flags.py's make_cfg(), from either package's config
    module, with motion gating on and `runtime` overrides."""
    return c.SLAMConfig(
        frontend=c.FrontendConfig(image_height=FH, image_width=FW,
                                  max_keypoints=FN, descriptor_dim=FD),
        geometry=c.GeometryConfig(essential_hypotheses=64,
                                  essential_refine_iters=3,
                                  triangulation_reproj_px=0.5),
        ba=c.BAConfig(max_window_cameras=8, max_window_points=512,
                      full_ba_iters=8, pose_only_iters=8),
        map=c.MapConfig(max_keyframes=32, max_points=2048,
                        covis_max_points=128, covis_edge_threshold=10),
        runtime=c.RuntimeConfig(every_frame_keyframe=False, **runtime))


@pytest.fixture(scope="module")
def flags_scene():
    return synthetic.make_scene(num_landmarks=1200, num_frames=12,
                                height=FH, width=FW, desc_dim=FD, seed=42)


def _per_frame(scene, n, **runtime):
    """(JAX pipeline, port pipeline) over n frames, BA off, on the same
    RANSAC draws."""
    obs = [synthetic.observe_frame(scene, i, max_keypoints=FN, seed=9)
           for i in range(n)]
    jcfg = flags_cfg(j_config, **runtime)
    jp = JPipeline(jcfg, scene.K, enable_ba=False)
    tp_mod._drive(jp, scene, obs)
    tp = TrackingPipeline(flags_cfg(t_config, **runtime), scene.K,
                          enable_ba=False, device="cpu",
                          draws=tp_mod.jax_draws(jcfg, n - 1))
    tp_mod._drive(tp, scene, obs)
    assert next(tp._draws, None) is None     # one draw set per step
    return jp, tp


def _oks(pipe):
    return [bool(np.asarray(o.frame_ok)) for o in pipe.outputs[1:]]


# (filters, frames, the frames kept as keyframes)
FLAG_CASES = {
    "none": (dict(gt_mag_filter=1e6, gt_rot_filter=1e6), 6, [0, 1]),
    "all": (dict(gt_mag_filter=1e-6, gt_rot_filter=1e-6), 6,
            list(range(6))),
    "every-third": (KEEP_THIRD, 12, [0, 1, 4, 7, 10]),
}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_per_frame_motion_gate_matches_jax(flags_scene, case):
    runtime, n, kept = FLAG_CASES[case]
    jp, tp = _per_frame(flags_scene, n, **runtime)
    assert _oks(tp) == _oks(jp)
    assert tp.map_stats()["num_keyframes"] == len(kept) \
        == jp.map_stats()["num_keyframes"]
    _, _, fidx = tp.trajectory()
    assert fidx.tolist() == kept
    # the kept poses within tests/test_torch_pipeline.py's tolerances
    Rj, tj, _ = jp.trajectory()
    R, t, _ = tp.trajectory()
    np.testing.assert_allclose(R, Rj, atol=tp_mod.R_TOL)
    np.testing.assert_allclose(t, tj, atol=tp_mod.T_TOL)
    # a rejected frame reports the last kept pose
    j, p = tp_mod._outputs(jp), tp_mod._outputs(tp)
    np.testing.assert_allclose(p["t"], j["t"], atol=tp_mod.T_TOL)


def test_a_filter_between_one_and_two_steps_locks_out_like_jax(
        flags_scene):
    """A 1.5 m filter on ~1 m steps with the step-ratio check on (bound 2):
    frame 2 (1 m) is rejected; frame 3 lies 2 m from the last keyframe
    against a carried ~1 m step, the ratio check fails, the soft fallback
    hands back the ~1 m prediction and the gate rejects it again; every
    later frame only widens the ratio. No frame after the bootstrap is ever
    kept, in the JAX package as in the port (ROADMAP.md, a fault in the
    JAX package)."""
    jp, tp = _per_frame(flags_scene, 8, gt_mag_filter=1.5, gt_rot_filter=1e6)
    assert _oks(tp) == _oks(jp) == [False] * 6
    ratio = [float(o.dbg_step_ratio) for o in tp.outputs[1:]]
    assert all(b > a + 0.5 for a, b in zip(ratio, ratio[1:])), ratio
    assert ratio[1] > 2.0
    assert not any(bool(o.dbg_soft_ok) for o in tp.outputs[2:])
