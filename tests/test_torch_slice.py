"""The whole slice: the chunked learned tracker in JAX and in the port.

Both run the micro pipeline (committed tiny weights, BA and loop closing
off, centroid sub-pixel refinement) over the same rendered frames: a
bootstrap plus two chunks of 8. The port's RANSAC draws are the
reference's own: the JAX key recurrence (bootstrap `split(key)`, then
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

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
H, W, N, NF, CHUNK = 240, 320, 128, 18, 8


def _no_backend(cfg):
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, run_full_ba=False, loop_closing=False))


@pytest.fixture(scope="module")
def both_runs():
    D = j_e2e.TINY_DESC_DIM
    # The held-out scene of tests/test_learned_e2e.py
    scene = synthetic.make_scene(num_landmarks=900, num_frames=NF,
                                 height=H, width=W, desc_dim=D, seed=11)
    stack = t_e2e.render_stack(scene, NF, N)
    c0 = -scene.poses_R[0].T @ scene.poses_t[0]
    c1 = -scene.poses_R[1].T @ scene.poses_t[1]
    scale = float(np.linalg.norm(c1 - c0))

    sp, spp, lg, lgp = j_e2e.load_tiny_frontend(CKPT)
    sp = sp.clone(dtype=jnp.float32)
    lg = lg.clone(dtype=jnp.float32)
    cfg = _no_backend(j_e2e.micro_config(H, W, N, D))
    jp = JPipeline(cfg, jnp.asarray(scene.K, jnp.float32), sp, lg,
                   j_fused.FusedParams(sp=spp, lg=lgp), chunk=CHUNK,
                   enable_ba=False)
    jp.bootstrap_from_images(stack[0], stack[1], scale)
    for s in range(2, NF, CHUNK):
        jp.track_chunk(jnp.asarray(stack[s:s + CHUNK]), s)
    ref = jp.stacked_outputs()

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

    tsp, tlg = t_e2e.load_tiny_frontend(CKPT, device="cpu",
                                        dtype=torch.float32)
    tcfg = _no_backend(t_cfg.micro_config(H, W, N, D))
    diag = {}
    res = t_e2e.run_learned_e2e(tsp, tlg, scene, tcfg, NF, chunk=CHUNK,
                                device="cpu", draws=feed, stack=stack,
                                diag_out=diag)
    assert pos[0] == NF - 1          # every reference draw was consumed
    return ref, diag["outputs"], res


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


def test_backend_stages_raise_instead_of_skipping():
    cfg = t_cfg.micro_config(H, W, N, 64)
    with pytest.raises(NotImplementedError, match="window BA"):
        ChunkedPipeline(cfg, np.eye(3), None, None, device="cpu")
    with pytest.raises(NotImplementedError, match="loop closing"):
        ChunkedPipeline(cfg, np.eye(3), None, None, device="cpu",
                        enable_ba=False)
