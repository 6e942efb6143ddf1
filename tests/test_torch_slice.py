"""The whole slice: the chunked learned tracker in JAX and in the port.

Both run the micro pipeline (committed tiny weights, loop closing off,
centroid sub-pixel refinement) over the same rendered frames: a bootstrap
plus two chunks of 8, once with BA off and once with a window BA pass
(with slot recycling and the health check) every 8 frames; and, with BA,
a bootstrap plus one chunk of 8 and a tail of 5 frames padded to 8 and
gated off by `frame_gate`. The port's
RANSAC draws are the reference's own: the JAX key recurrence (bootstrap `split(key)`, then
`split(key, 3)` per frame) is replayed here and each frame's
`jax.random.uniform(k_ess, (hypotheses, 8))` is fed to the port through
ChunkedPipeline's `draws`.
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

import jax_weights

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
H, W, N, NF, CHUNK = 240, 320, 128, 18, 8


def _backend(cfg, ba):
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, run_full_ba=ba, loop_closing=False))


def _jax_draws(cfg):
    """(feed, consumed): the reference's RANSAC draws for the bootstrap and
    NF - 2 frames, handed out in order by feed(n); consumed[0] counts them."""
    hyp = cfg.geometry.essential_hypotheses
    key, k_ess = jax.random.split(jax.random.PRNGKey(0))
    draws = [np.asarray(jax.random.uniform(k_ess, (hyp, 8)))]
    for _ in range(NF - 2):
        key, k_ess, _ = jax.random.split(key, 3)
        draws.append(np.asarray(jax.random.uniform(k_ess, (hyp, 8))))
    pos = [0]

    def feed(n):
        out = np.stack(draws[pos[0]:pos[0] + n])
        pos[0] += n
        return torch.from_numpy(out)

    return feed, pos


def _scene():
    """The held-out scene of tests/test_learned_e2e.py, its NF rendered
    frames and the bootstrap's ground-truth scale."""
    scene = synthetic.make_scene(num_landmarks=900, num_frames=NF,
                                 height=H, width=W,
                                 desc_dim=j_e2e.TINY_DESC_DIM, seed=11)
    stack = t_e2e.render_stack(scene, NF, N)
    c0 = -scene.poses_R[0].T @ scene.poses_t[0]
    c1 = -scene.poses_R[1].T @ scene.poses_t[1]
    return scene, stack, float(np.linalg.norm(c1 - c0))


def _both_runs(ba):
    """(JAX per-frame outputs, port per-frame outputs, port E2EResult, JAX
    pipeline) of one run of each side, with or without BA."""
    D = j_e2e.TINY_DESC_DIM
    scene, stack, scale = _scene()

    sp, spp, lg, lgp = jax_weights.load_tiny_frontend(CKPT)
    sp = sp.clone(dtype=jnp.float32)
    lg = lg.clone(dtype=jnp.float32)
    cfg = _backend(j_e2e.micro_config(H, W, N, D), ba)
    jp = JPipeline(cfg, jnp.asarray(scene.K, jnp.float32), sp, lg,
                   j_fused.FusedParams(sp=spp, lg=lgp), chunk=CHUNK,
                   ba_every=CHUNK, enable_ba=ba)
    jp.bootstrap_from_images(stack[0], stack[1], scale)
    for s in range(2, NF, CHUNK):
        jp.track_chunk(jnp.asarray(stack[s:s + CHUNK]), s)
    ref = jp.stacked_outputs()

    feed, pos = _jax_draws(cfg)
    tsp, tlg = t_e2e.load_tiny_frontend(CKPT, device="cpu",
                                        dtype=torch.float32)
    tcfg = _backend(t_cfg.micro_config(H, W, N, D), ba)
    diag = {}
    res = t_e2e.run_learned_e2e(tsp, tlg, scene, tcfg, NF, chunk=CHUNK,
                                ba_every=CHUNK, device="cpu", draws=feed,
                                stack=stack, diag_out=diag, ba_diag=ba)
    assert pos[0] == NF - 1          # every reference draw was consumed
    return ref, diag, res, jp


@pytest.fixture(scope="module")
def both_runs():
    ref, diag, res, _ = _both_runs(ba=False)
    return ref, diag["outputs"], res


@pytest.fixture(scope="module")
def both_runs_ba():
    return _both_runs(ba=True)


def test_slice_poses_match_jax(both_runs):
    ref, got, _ = both_runs
    # float32 in both frameworks with other summation orders. Over the
    # first chunk the poses agree to ~1e-5 rad / ~5e-4 m. The differences
    # then grow through the map (each frame's points anchor the next
    # poses), and a correspondence that lands on the other side of the
    # Sampson threshold moves that frame's pose by centimetres (measured
    # 2.9e-2 m at the last frame, on ~1 m steps).
    np.testing.assert_allclose(got.R, ref.R, atol=1e-3)
    np.testing.assert_allclose(got.t[:CHUNK], ref.t[:CHUNK], atol=1e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=5e-2)


def test_slice_counts_match_jax(both_runs):
    ref, got, _ = both_runs
    np.testing.assert_array_equal(got.frame_ok, ref.frame_ok)
    np.testing.assert_array_equal(got.num_matches, ref.num_matches)
    # A correspondence on the Sampson threshold may fall either side under
    # another summation order: at most 2 inliers per frame, in few frames.
    d = np.abs(got.num_inliers.astype(int) - ref.num_inliers.astype(int))
    assert d.max() <= 2 and (d > 0).sum() <= 2, (got.num_inliers,
                                                    ref.num_inliers)
    dm = np.abs(got.num_map_matches.astype(int)
                - ref.num_map_matches.astype(int))
    assert dm.max() <= 2 and (dm > 0).sum() <= 2


def test_slice_tracks(both_runs):
    _, got, res = both_runs
    assert res.num_keyframes == NF and res.num_rejected == 0
    assert res.mean_matches > 50
    assert np.isfinite(got.R).all() and np.isfinite(got.t).all()
    assert res.ate_m < 1.0, res


def test_ba_slice_runs_ba_like_jax(both_runs_ba):
    ref, diag, res, jp = both_runs_ba
    assert res.num_ba_runs == jp.num_ba_runs == 2
    assert diag["num_recoveries"] == jp.num_recoveries == 0
    assert res.num_keyframes == NF and res.num_rejected == 0
    assert res.mean_matches > 50 and res.ate_m < 1.0, res
    # each pass lowers the mean reprojection error of its window
    assert len(diag["ba_reproj"]) == 2
    for before, after in diag["ba_reproj"]:
        assert after < before, diag["ba_reproj"]


def test_ba_slice_poses_match_jax(both_runs_ba):
    ref, diag, _, jp = both_runs_ba
    got = diag["outputs"]
    # As test_slice_poses_match_jax: float32 in other summation orders, the
    # first chunk (before any BA) to 1e-3; the second chunk starts from the
    # BA-refined map and carry of each side, within the same 5e-2 m.
    np.testing.assert_allclose(got.R, ref.R, atol=1e-3)
    np.testing.assert_allclose(got.t[:CHUNK], ref.t[:CHUNK], atol=1e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=5e-2)
    # the maps after the second BA pass and its recycling
    jR, jt, jidx = jp.trajectory()
    np.testing.assert_array_equal(diag["frame_idx"], jidx)
    np.testing.assert_allclose(diag["R"], jR, atol=1e-3)
    np.testing.assert_allclose(diag["t"], jt, atol=5e-2)


def test_ba_slice_counts_match_jax(both_runs_ba):
    ref, diag, _, _ = both_runs_ba
    got = diag["outputs"]
    np.testing.assert_array_equal(got.frame_ok, ref.frame_ok)
    np.testing.assert_array_equal(got.num_matches, ref.num_matches)
    # As test_slice_counts_match_jax: threshold decisions under another
    # summation order, at most 2 per frame, in few frames.
    d = np.abs(got.num_inliers.astype(int) - ref.num_inliers.astype(int))
    assert d.max() <= 2 and (d > 0).sum() <= 2, (got.num_inliers,
                                                    ref.num_inliers)
    dm = np.abs(got.num_map_matches.astype(int)
                - ref.num_map_matches.astype(int))
    assert dm.max() <= 2 and (dm > 0).sum() <= 2, (got.num_map_matches,
                                                     ref.num_map_matches)


# --- the padded tail chunk -------------------------------------------------

TAIL = 5                     # real frames of the tail chunk, padded to 8


@pytest.fixture(scope="module")
def tail_runs(both_runs_ba):
    """Bootstrap, one chunk of 8, then frames 10-14 padded to a chunk of 8
    with copies of frame 14 and gated (`frame_gate`), BA every chunk, on
    each side: (JAX outputs, JAX pipeline, port outputs, port pipeline).
    The JAX pipeline runs the programs that `both_runs_ba`'s pipeline
    compiled for the same configuration and networks (a fresh `jax.jit`
    would compile them again)."""
    D = j_e2e.TINY_DESC_DIM
    scene, stack, scale = _scene()
    first = stack[2:2 + CHUNK]
    tail = np.concatenate([stack[2 + CHUNK:2 + CHUNK + TAIL],
                           np.repeat(stack[1 + CHUNK + TAIL][None],
                                     CHUNK - TAIL, axis=0)])
    gate = np.arange(CHUNK) < TAIL

    sp, spp, lg, lgp = jax_weights.load_tiny_frontend(CKPT)
    cfg = _backend(j_e2e.micro_config(H, W, N, D), ba=True)
    jp = JPipeline(cfg, jnp.asarray(scene.K, jnp.float32),
                   sp.clone(dtype=jnp.float32), lg.clone(dtype=jnp.float32),
                   j_fused.FusedParams(sp=spp, lg=lgp), chunk=CHUNK,
                   ba_every=CHUNK)
    compiled = both_runs_ba[3]
    assert compiled.cfg == cfg and compiled.enable_ba and jp.enable_ba
    jp.chunk_fn, jp.extract_fn, jp._ba_fn = (compiled.chunk_fn,
                                             compiled.extract_fn,
                                             compiled._ba_fn)
    jp.bootstrap_from_images(stack[0], stack[1], scale)
    jp.track_chunk(jnp.asarray(first), 2)
    jp.track_chunk(jnp.asarray(tail), 2 + CHUNK, frame_gate=gate)

    feed, pos = _jax_draws(cfg)
    tsp, tlg = t_e2e.load_tiny_frontend(CKPT, device="cpu",
                                        dtype=torch.float32)
    tp = ChunkedPipeline(_backend(t_cfg.micro_config(H, W, N, D), ba=True),
                         scene.K, tsp, tlg, chunk=CHUNK, ba_every=CHUNK,
                         device="cpu", draws=feed)
    tp.bootstrap_from_images(stack[0], stack[1], scale)
    tp.track_chunk(first, 2)
    tp.track_chunk(tail, 2 + CHUNK, frame_gate=gate)
    assert pos[0] == 1 + 2 * CHUNK   # every padded frame drew too
    return jp.stacked_outputs(), jp, tp.stacked_outputs(), tp


def test_tail_chunk_poses_and_counts_match_jax(tail_runs):
    ref, _, got, _ = tail_runs
    real = np.arange(2 * CHUNK) < CHUNK + TAIL
    np.testing.assert_array_equal(got.frame_ok, ref.frame_ok)
    np.testing.assert_array_equal(got.frame_ok, real)   # padding rejected
    np.testing.assert_array_equal(got.num_matches, ref.num_matches)
    # As test_slice_counts_match_jax: threshold decisions under another
    # summation order, at most 2 per frame, in few frames.
    for name in ("num_inliers", "num_map_matches"):
        d = np.abs(getattr(got, name).astype(int)
                   - getattr(ref, name).astype(int))
        assert d.max() <= 2 and (d > 0).sum() <= 2, name
    np.testing.assert_array_equal(got.num_new_points[~real], 0)
    # The tolerances of test_slice_poses_match_jax; a padded frame reports
    # the pose of the last accepted frame.
    np.testing.assert_allclose(got.R, ref.R, atol=1e-3)
    np.testing.assert_allclose(got.t[:CHUNK], ref.t[:CHUNK], atol=1e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=5e-2)
    last = CHUNK + TAIL - 1
    np.testing.assert_array_equal(got.t[~real], np.repeat(
        got.t[last][None], CHUNK - TAIL, axis=0))


def test_tail_chunk_final_state_matches_jax(tail_runs):
    _, jp, _, tp = tail_runs
    st, jst = tp.state, jp.state
    for name, x in [*st.map._asdict().items(), *st._asdict().items()]:
        if torch.is_tensor(x) and x.is_floating_point():
            assert bool(torch.isfinite(x).all()), name
    n = int(st.map.num_kf)
    assert n == int(jst.map.num_kf) == 2 + CHUNK + TAIL
    assert tp.num_ba_runs == jp.num_ba_runs == 2
    assert tp.num_recoveries == jp.num_recoveries == 0
    R, t, fidx = tp.trajectory()
    jR, jt, jidx = jp.trajectory()
    np.testing.assert_array_equal(fidx, jidx)
    np.testing.assert_array_equal(fidx, np.arange(n))
    np.testing.assert_allclose(R, jR, atol=1e-3)
    np.testing.assert_allclose(t, jt, atol=5e-2)
    np.testing.assert_allclose(st.R_cur.numpy(), np.asarray(jst.R_cur),
                               atol=1e-3)
    np.testing.assert_allclose(st.t_cur.numpy(), np.asarray(jst.t_cur),
                               atol=5e-2)
    # the carried features are the last real frame's
    np.testing.assert_array_equal(st.prev_valid.numpy(),
                                  np.asarray(jst.prev_valid))
    np.testing.assert_allclose(st.prev_kpts.numpy(),
                               np.asarray(jst.prev_kpts), atol=1e-3)


def test_backend_stages_raise_instead_of_skipping():
    """Every backend stage runs, loop closing included; the PnP tracker
    builds with its own draws; a sub-pixel head that is neither of the two
    heads raises instead of being skipped."""
    cfg = t_cfg.micro_config(H, W, N, 64)
    sp, lg = t_e2e.load_tiny_frontend(CKPT, device="cpu",
                                      dtype=torch.float32)
    pipe = ChunkedPipeline(cfg, np.eye(3), sp, lg, device="cpu",
                           enable_ba=False)
    assert cfg.runtime.loop_closing and pipe._detect_fn is not None
    assert pipe.num_loop_closures == 0 and pipe.loop_checks == []
    with pytest.raises(TypeError, match="SubpixHead or a PairSubpixHead"):
        ChunkedPipeline(cfg, np.eye(3), sp, lg, device="cpu",
                        subpix_head=object())
    pnp = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                  tracker="pnp"))
    pnp_pipe = ChunkedPipeline(pnp, np.eye(3), sp, lg, device="cpu")
    assert tuple(pnp_pipe.pnp_draw(2).shape) == (
        2, cfg.geometry.pnp_hypotheses, cfg.frontend.max_keypoints)
    pipe = ChunkedPipeline(_backend(cfg, ba=True), np.eye(3), sp, lg,
                           device="cpu")
    assert pipe.enable_ba and pipe.num_ba_runs == 0
