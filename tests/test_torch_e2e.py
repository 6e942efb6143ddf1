"""The port's learned pipeline end to end with its backend, on the CPU.

The ROADMAP's gate for the window BA: the port's `run_learned_e2e` on the
held-out scene of tests/test_learned_e2e.py::test_learned_pipeline_tracks
within that test's bounds, and the health check's rollback on a poisoned
pose (as tests/test_async_ba.py::test_health_check_recovers_from_nan).
Committed tiny weights in float32; no JAX here.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gl_slam_tpu_torch import config as t_cfg
from gl_slam_tpu_torch.io import synthetic
from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline
from gl_slam_tpu_torch.train import e2e

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
H, W, N = 240, 320, 128
D = t_cfg.TINY_DESC_DIM


def _cfg():
    cfg = t_cfg.micro_config(H, W, N, D)
    return cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                   loop_closing=False))


@pytest.fixture(scope="module")
def frontend():
    return e2e.load_tiny_frontend(CKPT, device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(num_landmarks=900, num_frames=32, height=H,
                                width=W, desc_dim=D, seed=11)


def test_learned_pipeline_tracks_with_ba(frontend, scene):
    sp, lg = frontend
    diag = {}
    res = e2e.run_learned_e2e(sp, lg, scene, _cfg(), n_frames=32,
                              device="cpu", diag_out=diag, ba_diag=True)
    # the bounds of tests/test_learned_e2e.py (chunk 5, ba_every 3)
    assert res.ate_m < 1.0, res
    assert res.num_keyframes == 32, res
    assert res.mean_matches > 50, res
    assert res.num_ba_runs >= 5, res
    assert diag["num_recoveries"] == 0
    assert len(diag["ba_reproj"]) == res.num_ba_runs
    assert all(np.isfinite(b) and np.isfinite(a) for b, a in
               diag["ba_reproj"])
    iters = _cfg().ba.full_ba_iters
    assert all(2 <= k <= iters for k in diag["ba_lm_iters"]), diag


def test_ba_does_not_degrade_ate(frontend, scene):
    sp, lg = frontend
    cfg = _cfg()
    off = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                  run_full_ba=False))
    stack = e2e.render_stack(scene, 17, N)
    with_ba = e2e.run_learned_e2e(sp, lg, scene, cfg, 17, device="cpu",
                                  stack=stack)
    without = e2e.run_learned_e2e(sp, lg, scene, off, 17, device="cpu",
                                  stack=stack)
    assert with_ba.num_ba_runs == 3 and without.num_ba_runs == 0
    assert with_ba.num_keyframes == without.num_keyframes == 17
    assert with_ba.ate_m <= max(1.5 * without.ate_m, 0.1), (with_ba, without)


def _tracked_pipe(frontend, scene, n_chunks, subpix=None):
    sp, lg = frontend
    stack = e2e.render_stack(scene, 2 + 5 * n_chunks, N)
    pipe = ChunkedPipeline(_cfg(), scene.K, sp, lg, chunk=5, ba_every=5,
                           device="cpu", subpix_head=subpix)
    c = [-scene.poses_R[i].T @ scene.poses_t[i] for i in (0, 1)]
    pipe.bootstrap_from_images(stack[0], stack[1],
                               float(np.linalg.norm(c[1] - c[0])))
    for k in range(n_chunks):
        pipe.track_chunk(stack[2 + 5 * k:7 + 5 * k])
    return pipe


def _assert_states_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if name == "map":
            for mname, mx, my in zip(x._fields, x, y):
                assert torch.equal(mx, my), mname
        elif x is None or y is None:          # prev_patches outside pair mode
            assert x is None and y is None, name
        else:
            assert torch.equal(x, y), name


def _tensors(state):
    return [x for x in (*state.map, *state[1:]) if x is not None]


def test_health_check_rolls_back_a_poisoned_pose(frontend, scene):
    _poison_and_roll_back(frontend, scene, None)


def test_health_check_rolls_back_the_carried_patches(frontend, scene):
    """As above in pair mode: the snapshot, and so the rollback, carries the
    pair sub-pixel head's patches of the last accepted frame."""
    head = e2e.load_tiny_subpix(CKPT, pair=True, device="cpu",
                                dtype=torch.float32)
    good = _poison_and_roll_back(frontend, scene, head)
    assert good.prev_patches is not None
    assert good.prev_patches.shape == (N, head.patch, head.patch)


def _poison_and_roll_back(frontend, scene, subpix):
    pipe = _tracked_pipe(frontend, scene, 2, subpix)
    assert pipe.num_ba_runs == 2 and pipe.num_recoveries == 0
    assert pipe._last_good is not None        # the first trigger, verified
    good = pipe._pending_health[2]            # the second, still pending
    kept = [x.clone() for x in _tensors(good)]
    pipe.state = pipe.state._replace(
        t_cur=torch.full((3,), float("nan")))
    stack = e2e.render_stack(scene, 22, N)
    # The next BA trigger verifies the pending snapshot and takes the
    # poisoned state's pose (the chunk tracked from NaN stays NaN) ...
    pipe.track_chunk(stack[12:17])
    assert pipe.num_ba_runs == 3 and pipe.num_recoveries == 0
    assert pipe._last_good is good
    assert not bool(torch.isfinite(pipe.state.t_cur).any())
    # ... and the one after finds it non-finite and rolls back, taking no
    # new snapshot.
    pipe.track_chunk(stack[17:22])
    assert pipe.num_ba_runs == 4 and pipe.num_recoveries == 1
    assert pipe._pending_health is None
    _assert_states_equal(pipe.state, good)
    # the chunks tracked meanwhile wrote nothing into the snapshot's tensors
    for x, y in zip(kept, _tensors(good), strict=True):
        assert torch.equal(x, y)
    assert bool(torch.isfinite(pipe.state.t_cur).all())
    # Tracking goes on from the restored state (12 keyframes).
    outs = pipe.track_chunk(stack[12:17], 12)
    assert all(bool(o.frame_ok) for o in outs)
    assert pipe.num_recoveries == 1 and pipe._pending_health is not None
    R, t, fidx = pipe.trajectory()
    assert list(fidx) == list(range(17))
    assert np.isfinite(R).all() and np.isfinite(t).all()
    return good


def test_bootstrap_from_state_continues_a_run(frontend, scene):
    """A second pipeline adopts the first one's state and tracks on."""
    first = _tracked_pipe(frontend, scene, 1)
    sp, lg = frontend
    pipe = ChunkedPipeline(_cfg(), scene.K, sp, lg, chunk=5, ba_every=5,
                           device="cpu")
    pipe.bootstrap_from_state(first.state, num_frames=7)
    stack = e2e.render_stack(scene, 12, N)
    outs = pipe.track_chunk(stack[7:12])
    pipe.finish()
    assert all(bool(o.frame_ok) for o in outs)
    assert pipe.num_ba_runs == 1
    R, t, fidx = pipe.trajectory()
    assert list(fidx) == list(range(12))
    assert np.isfinite(R).all() and np.isfinite(t).all()


def test_run_learned_e2e_renders_in_the_given_domain(frontend, scene,
                                                     monkeypatch):
    """`domain` reaches the renderer when no stack is given (the eval
    scripts' `--domain`)."""
    sp, lg = frontend
    seen = []
    render = e2e.render_stack

    def spy(scene_, n, max_keypoints, domain="clean"):
        seen.append(domain)
        return render(scene_, n, max_keypoints, domain=domain)

    monkeypatch.setattr(e2e, "render_stack", spy)
    cfg = _cfg()
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                  run_full_ba=False))
    res = e2e.run_learned_e2e(sp, lg, scene, cfg, 3, chunk=1, device="cpu",
                              domain="hard")
    assert seen == ["hard"]
    assert res.num_frames == 3 and np.isfinite(res.ate_m)
