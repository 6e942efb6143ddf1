"""The port's geometry solvers against the JAX package.

Tie-stable top-k, the essential RANSAC (with the reference's own draws fed
in) and the multi-start pose LM, on numpy-seeded two-view problems, both
sides in float32 at "highest" matmul precision (tests/conftest.py).
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu.geometry import essential as j_ess
from gl_slam_tpu.slam import pose_ba as j_pose
from gl_slam_tpu_torch.geometry import essential as t_ess
from gl_slam_tpu_torch.ops.select import topk_stable
from gl_slam_tpu_torch.slam import pose_ba as t_pose

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_topk_stable_matches_lax_top_k_on_ties():
    rng = np.random.default_rng(10)
    x = rng.integers(-1, 4, size=(5, 300)).astype(np.int32)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 40)
    vt, it = topk_stable(*_t(x), 40)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def _two_view(seed, N=96):
    r = np.random.default_rng(seed)
    K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], np.float32)
    X = np.c_[r.uniform(-5, 5, N), r.uniform(-3, 3, N),
              r.uniform(4, 30, N)].astype(np.float32)
    a = 0.04
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    t = np.array([0.1, 0.0, 1.0], np.float32)
    p0 = X @ K.T
    p1 = (X @ R.T + t) @ K.T
    uv0 = (p0[:, :2] / p0[:, 2:]).astype(np.float32)
    uv1 = (p1[:, :2] / p1[:, 2:] + r.normal(0, 0.3, (N, 2))).astype(
        np.float32)
    return K, X, R, t, uv0, uv1, r.uniform(size=N) < 0.85


def test_essential_matches_jax_with_shared_draws():
    """The RANSAC draws are an argument: fed the reference's own
    jax.random.uniform draws, the batched port reproduces each pair."""
    B, H = 3, 48
    pairs = [_two_view(s) for s in range(B)]
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    u = np.stack([np.asarray(jax.random.uniform(k, (H, 8))) for k in keys])
    K = pairs[0][0]
    got = t_ess.estimate_essential(
        *_t(K, np.stack([p[4] for p in pairs]), np.stack([p[5] for p in pairs]),
            np.stack([p[6] for p in pairs]), u),
        threshold_px=0.75, num_hypotheses=H, refine_iters=5)
    ref = jax.jit(jax.vmap(functools.partial(
        j_ess.estimate_essential, threshold_px=0.75, num_hypotheses=H,
        refine_iters=5), in_axes=(None, 0, 0, 0, 0)))(
        K, np.stack([p[4] for p in pairs]), np.stack([p[5] for p in pairs]),
        np.stack([p[6] for p in pairs]), keys)
    # float32 closed-form solvers in other summation orders
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))


def test_pose_only_ba_multi_matches_jax():
    K, X, R, t, _, _, mask = _two_view(11, N=80)
    r = np.random.default_rng(12)
    p = X @ R.T + t
    uv = ((p @ K.T)[:, :2] / p[:, 2:3]).astype(np.float32)
    uv += r.normal(0, 0.5, uv.shape).astype(np.float32)
    uv[:8] += 30.0                              # outliers
    starts_R = np.stack([R, np.eye(3, dtype=np.float32), R]).astype(
        np.float32)
    starts_t = np.stack([t + 0.05, t, t - 0.1]).astype(np.float32)
    w = np.where(r.uniform(size=80) < 0.3, 0.2, 1.0).astype(np.float32)
    kw = dict(iters=12, cauchy_scale=1.0, coarse_iters=4,
              coarse_scale_mult=8.0)
    ref = j_pose.pose_only_ba_multi(K, starts_R, starts_t, X, uv, mask,
                                    point_weights=w, **kw)
    got = t_pose.pose_only_ba_multi(*_t(K, starts_R, starts_t, X, uv, mask),
                                    point_weights=torch.from_numpy(w), **kw)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(got.final_cost.numpy(),
                               np.asarray(ref.final_cost), rtol=1e-4)


def test_project_near_so3_keeps_a_near_rotation():
    """A keyframe rotation that a window BA solved on the card (turned
    ~90 degrees about the camera's y axis; orthonormal to 1.2e-7): the
    closed-form SVD projection turns it by 1.6e-4 (R^T R's three
    eigenvalues meet, and eigh3x3's eigenvectors lose orthogonality), which
    raised that BA pass's robust cost by ~27 %. project_near_so3 falls back
    to a Newton-Schulz step there, and gives project_to_so3's result where
    that is orthonormal."""
    from gl_slam_tpu_torch.geometry import se3
    bits = np.array([[3123478326, 965201152, 3212836861],
                     [962593637, 1065353216, 965196310],
                     [1065353213, 3110065583, 3123479274]], dtype=np.uint32)
    R = torch.from_numpy(bits.view(np.float32).copy())
    eye = torch.eye(3)

    def off(M):
        return float((M.T @ M - eye).abs().max())

    assert off(R) < 2e-7
    P = se3.project_to_so3(R)
    assert off(P) > 1e-4 and float((P - R).abs().max()) > 1e-4
    Q = se3.project_near_so3(R)
    assert off(Q) < 1e-7 and float((Q - R).abs().max()) < 2e-7
    W = se3.exp_so3(torch.from_numpy(
        np.random.default_rng(5).normal(size=(2000, 3)).astype(np.float32)))
    P, Q = se3.project_to_so3(W), se3.project_near_so3(W)
    kept = (P.transpose(-1, -2) @ P - eye).abs().amax((-2, -1)) <= 2e-6
    assert bool(kept.any()) and bool((~kept).any())
    assert torch.equal(Q[kept], P[kept])
    # where the SVD lost orthogonality, the polished rotation stays within
    # rounding of the exact one
    assert float((Q[~kept].transpose(-1, -2) @ Q[~kept] - eye).abs().max()) \
        < 1e-6
    assert float((Q[~kept] - W[~kept]).abs().max()) < 5e-7
