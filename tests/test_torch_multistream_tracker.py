"""MultiStreamTracker: the port against JAX.

The set-up of the JAX package's multi-chip dry run (part 1,
`__graft_entry__.dryrun_multichip`), on the tiny test configuration and
without a mesh, with three DISTINCT streams: synthetic scenes of seeds 1,
2 and 3 (oracle observations, N = 128, D = 64). Both trackers bootstrap
on frames 0-1, step frames 2 and 3 and run one window BA pass over
keyframes 0-3; the port takes each stream's draws from the JAX tracker's
per-stream key recurrence (keys `split(PRNGKey(0), 3)`, the bootstrap's
`split(key)`, each step's `split(key, 3)`).

Tolerances: frame_ok and match counts equal, inlier counts within 2
(threshold decisions under another summation order), poses to 1e-3
before and after the BA pass (tests/test_torch_slice.py's first-chunk
bounds); after the pass `R_cur` / `t_cur` are each stream's last
keyframe pose, as in JAX. A device list of three entries (one stream a
part) agrees with one device to 1e-4.

Distinct intrinsics per stream: the same three scenes, each with a K of
its own (f moved by +1, -2 and +3 %, the principal point by -1, +2 and
-3 %, as tests/test_torch_intrinsics.py's cameras), through both trackers
with (S, 3, 3) K, within the tolerances above; and in the port a K whose
rows are all equal gives the bits of the shared (3, 3) K.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu.config import tiny_test_config as j_tiny
from gl_slam_tpu.io import synthetic
from gl_slam_tpu.parallel.multistream import MultiStreamTracker as JTracker
from gl_slam_tpu_torch.config import tiny_test_config as t_tiny
from gl_slam_tpu_torch.parallel.multistream import MultiStreamTracker

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

S = 3


def _scenes(cfg):
    fe = cfg.frontend
    return [synthetic.make_scene(num_landmarks=800, num_frames=4,
                                 height=fe.image_height, width=fe.image_width,
                                 desc_dim=fe.descriptor_dim, seed=1 + s)
            for s in range(S)]


def _frame(scenes, i, N):
    obs = [synthetic.observe_frame(sc, i, max_keypoints=N) for sc in scenes]
    return (np.stack([o.keypoints for o in obs]).astype(np.float32),
            np.stack([o.descriptors for o in obs]).astype(np.float32),
            np.stack([o.valid for o in obs]))


def _scales(scenes):
    out = []
    for sc in scenes:
        c0 = -sc.poses_R[0].T @ sc.poses_t[0]
        c1 = -sc.poses_R[1].T @ sc.poses_t[1]
        out.append(np.linalg.norm(c1 - c0))
    return np.asarray(out, np.float32)


def _draws(cfg, n_steps):
    """Per stream: the bootstrap's and each step's (hyp, 8) draws."""
    hyp = cfg.geometry.essential_hypotheses
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    boot, steps = [], [[] for _ in range(n_steps)]
    for k in keys:
        k, k_ess = jax.random.split(k)
        boot.append(np.asarray(jax.random.uniform(k_ess, (hyp, 8))))
        for i in range(n_steps):
            k, k_ess, _ = jax.random.split(k, 3)
            steps[i].append(np.asarray(jax.random.uniform(k_ess, (hyp, 8))))
    return np.stack(boot), [np.stack(u) for u in steps]


def _run_port(cfg, scenes, boot, steps, K=None, **kw):
    N = cfg.frontend.max_keypoints
    K = scenes[0].K if K is None else K
    tr = MultiStreamTracker(cfg, K, S, device="cpu", **kw)
    outs = [tr.bootstrap(_frame(scenes, 0, N), _frame(scenes, 1, N),
                         _scales(scenes), u=boot)]
    for i, u in enumerate(steps):
        outs.append(tr.step(*_frame(scenes, 2 + i, N), 2 + i, u=u))
    pre_ba = tr.state
    tr.ba(0, 4)
    tr.block()
    return tr, outs, pre_ba


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = j_tiny(), t_tiny()
    scenes = _scenes(jcfg)
    N = jcfg.frontend.max_keypoints
    jt = JTracker(jcfg, scenes[0].K, S)
    jouts = [jt.bootstrap(_frame(scenes, 0, N), _frame(scenes, 1, N),
                          _scales(scenes))]
    for i in range(2):
        jouts.append(jt.step(*_frame(scenes, 2 + i, N), 2 + i))
    jpre = jt.state
    jt.ba(0, 4)
    jt.block()
    boot, steps = _draws(jcfg, 2)
    tr, touts, tpre = _run_port(tcfg, scenes, boot, steps)
    return (jt, jouts, jpre), (tr, touts, tpre), (tcfg, scenes, boot, steps)


def test_bootstrap_and_steps_match_jax(runs):
    (_, jouts, jpre), (_, touts, tpre), _ = runs
    for j, t in zip(jouts, touts):
        np.testing.assert_array_equal(t.frame_ok.numpy(),
                                      np.asarray(j.frame_ok))
        np.testing.assert_array_equal(t.num_matches.numpy(),
                                      np.asarray(j.num_matches))
        d = np.abs(t.num_inliers.numpy().astype(int)
                   - np.asarray(j.num_inliers).astype(int))
        assert d.max() <= 2
        np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-3)
        np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-3)
    assert np.asarray(jouts[-1].frame_ok).all()
    np.testing.assert_array_equal(tpre.map.num_kf.numpy(),
                                  np.asarray(jpre.map.num_kf))
    np.testing.assert_array_equal(tpre.map.num_kf.numpy(), [4] * S)


def test_ba_matches_jax_and_reanchors(runs):
    (jt, _, jpre), (tr, _, tpre), _ = runs
    jm, tm = jt.state.map, tr.state.map
    np.testing.assert_allclose(tm.kf_R.numpy()[:, :4],
                               np.asarray(jm.kf_R)[:, :4], atol=1e-3)
    np.testing.assert_allclose(tm.kf_t.numpy()[:, :4],
                               np.asarray(jm.kf_t)[:, :4], atol=1e-3)
    # the pass moved the free cameras, in both packages
    moved = np.abs(tm.kf_t.numpy()[:, 2:4] - tpre.map.kf_t.numpy()[:, 2:4])
    jmoved = np.abs(np.asarray(jm.kf_t)[:, 2:4]
                    - np.asarray(jpre.map.kf_t)[:, 2:4])
    assert moved.max() > 0 and jmoved.max() > 0
    np.testing.assert_array_equal(tr.state.R_cur.numpy(),
                                  tm.kf_R.numpy()[:, 3])
    np.testing.assert_array_equal(tr.state.t_cur.numpy(),
                                  tm.kf_t.numpy()[:, 3])
    np.testing.assert_allclose(tr.state.t_cur.numpy(),
                               np.asarray(jt.state.t_cur), atol=1e-3)
    # no slot recycling and no t_rel_norm re-anchoring, as in JAX
    np.testing.assert_array_equal(tr.state.t_rel_norm.numpy(),
                                  tpre.t_rel_norm.numpy())
    np.testing.assert_array_equal(tm.free_count.numpy(), [0] * S)


def test_device_list_matches_one_device(runs):
    _, (tr, touts, _), (cfg, scenes, boot, steps) = runs
    tr3, outs3, _ = _run_port(cfg, scenes, boot, steps,
                              devices=["cpu"] * S)
    assert len(tr3.states) == S
    for a, b in zip(touts, outs3):
        np.testing.assert_array_equal(a.frame_ok.numpy(), b.frame_ok.numpy())
        np.testing.assert_array_equal(a.num_inliers.numpy(),
                                      b.num_inliers.numpy())
        np.testing.assert_allclose(a.t.numpy(), b.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(tr3.state.map.kf_t.numpy(),
                               tr.state.map.kf_t.numpy(), atol=1e-4)


def test_default_draws_are_per_stream():
    cfg = t_tiny()
    tr = MultiStreamTracker(cfg, np.eye(3, dtype=np.float32), S,
                            device="cpu", seed=7)
    u = tr.draw()
    assert u.shape == (S, cfg.geometry.essential_hypotheses, 8)
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[1], u[2])
    again = MultiStreamTracker(cfg, np.eye(3, dtype=np.float32), S,
                               device="cpu", seed=7).draw()
    assert torch.equal(u, again)


def _cameras(scenes):
    """Each scene with its own K: f moved by +1, -2, +3 %, the principal
    point by -1, +2, -3 %."""
    out = []
    for s, sc in enumerate(scenes):
        K = np.array(sc.K, np.float64)
        K[[0, 1], [0, 1]] *= 1 + (0.01, -0.02, 0.03)[s]
        K[[0, 1], [2, 2]] *= 1 + (-0.01, 0.02, -0.03)[s]
        out.append(sc._replace(K=K))
    return out


@pytest.fixture(scope="module")
def distinct_K(runs):
    """Both trackers over the scenes with their own cameras. The JAX
    tracker reuses the programs `runs` compiled (K is one of their inputs,
    so new values need no new program)."""
    (jt0, _, _), _, (tcfg, scenes, boot, steps) = runs
    scenes = _cameras(scenes)
    Ks = np.stack([sc.K for sc in scenes]).astype(np.float32)
    N = tcfg.frontend.max_keypoints
    jt = JTracker(j_tiny(), Ks, S)
    jt._bootstrap, jt._step, jt._ba = jt0._bootstrap, jt0._step, jt0._ba
    jouts = [jt.bootstrap(_frame(scenes, 0, N), _frame(scenes, 1, N),
                          _scales(scenes))]
    for i in range(2):
        jouts.append(jt.step(*_frame(scenes, 2 + i, N), 2 + i))
    jt.ba(0, 4)
    jt.block()
    tr = MultiStreamTracker(tcfg, Ks, S, device="cpu")
    touts = [tr.bootstrap(_frame(scenes, 0, N), _frame(scenes, 1, N),
                          _scales(scenes), u=boot)]
    for i, u in enumerate(steps):
        touts.append(tr.step(*_frame(scenes, 2 + i, N), 2 + i, u=u))
    tr.ba(0, 4)
    tr.block()
    return jt, jouts, tr, touts


def test_distinct_intrinsics_match_jax(distinct_K):
    jt, jouts, tr, touts = distinct_K
    assert len({K.tobytes() for K in np.asarray(jt.K)}) == S
    for j, t in zip(jouts, touts):
        np.testing.assert_array_equal(t.frame_ok.numpy(),
                                      np.asarray(j.frame_ok))
        np.testing.assert_array_equal(t.num_matches.numpy(),
                                      np.asarray(j.num_matches))
        d = np.abs(t.num_inliers.numpy().astype(int)
                   - np.asarray(j.num_inliers).astype(int))
        assert d.max() <= 2
        np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-3)
        np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-3)
    assert np.asarray(jouts[-1].frame_ok).all()
    jm, tm = jt.state.map, tr.state.map
    np.testing.assert_allclose(tm.kf_R.numpy()[:, :4],
                               np.asarray(jm.kf_R)[:, :4], atol=1e-3)
    np.testing.assert_allclose(tm.kf_t.numpy()[:, :4],
                               np.asarray(jm.kf_t)[:, :4], atol=1e-3)


def _leaves(tree):
    for x in tree:
        if isinstance(x, tuple):
            yield from _leaves(x)
        elif x is not None:
            yield x


def test_equal_K_rows_give_the_bits_of_a_shared_K(runs):
    _, (tr, touts, _), (cfg, scenes, boot, steps) = runs
    K = np.stack([np.asarray(scenes[0].K, np.float32)] * S)
    tr_rows, outs_rows, _ = _run_port(cfg, scenes, boot, steps, K=K)
    for a, b in zip(touts, outs_rows):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for x, y in zip(_leaves(tr.state), _leaves(tr_rows.state)):
        assert torch.equal(x, y)
