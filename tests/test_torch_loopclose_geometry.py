"""Loop closing's geometry in the port against the JAX package.

`se3.log_so3` and `rotation_angle_deg` (identity, tiny, mid and near-pi
rotations), the two Gauss-Newton solvers of `ops/optim` on the quadratic
of tests/test_loopclose.py, and the PnP pieces: the Hartley-normalised
DLT, the Gauss-Newton polish and the RANSAC, whose Gumbel draws the port
takes from JAX's key. Both sides run in float32 at "highest" matmul
precision (tests/conftest.py). The detector, the pose graph and the
closure on a tracked map: tests/test_torch_loopclose.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu.geometry import pnp as j_pnp
from gl_slam_tpu.geometry import se3 as j_se3
from gl_slam_tpu.ops import optim as j_optim
from gl_slam_tpu_torch.geometry import pnp as t_pnp
from gl_slam_tpu_torch.geometry import se3 as t_se3
from gl_slam_tpu_torch.ops import optim as t_optim

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

H, W = 240, 320


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# se3.log_so3


def _rotations():
    """Identity, tiny, mid and near-pi rotations (within 1e-3 of pi)."""
    rng = np.random.default_rng(3)
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.array([0.0, 1e-6, 3e-4, 0.05, 0.4, 1.0, 1.7, 2.5, 3.0,
                       np.pi - 1e-3, np.pi - 3e-4, np.pi - 2e-5])
    w = (axes * angles[:, None]).astype(np.float32)
    R = np.stack([_np(j_se3.exp_so3(jnp.asarray(x))) for x in w])
    return w, R


def test_log_so3_matches_jax():
    w, R = _rotations()
    want = _np(j_se3.log_so3_batched(jnp.asarray(R)))
    got = t_se3.log_so3(_t(R)).numpy()
    # the same closed forms in f32: one rounding of the trace moves theta
    # by ~6e-8 / sin(theta), ~6e-5 rad within 1e-3 of pi, 1e-6 elsewhere
    near_pi = np.linalg.norm(w, axis=1) > np.pi - 2e-3
    np.testing.assert_allclose(got[~near_pi], want[~near_pi], atol=2e-6)
    np.testing.assert_allclose(got[near_pi], want[near_pi], atol=1e-4)
    # and both recover the rotation vector (up to sign at pi)
    np.testing.assert_allclose(np.abs(got[~near_pi]), np.abs(w[~near_pi]),
                               atol=1e-3)
    ang_t = t_se3.rotation_angle_deg(_t(R)).numpy()
    ang_j = np.array([float(j_se3.rotation_angle_deg(jnp.asarray(r)))
                      for r in R])
    np.testing.assert_allclose(ang_t, ang_j, atol=1e-2)


def test_log_so3_jacobian_is_finite_at_zero():
    """d log(exp(v)) / dv is the identity at v = 0: forward mode through
    the clamped arccos gives it, where the unclamped one gives NaN. The
    clamp holds theta at ~4.5e-4 rad, where the 1e-8 guard in
    theta / (2 sin theta + 1e-8) moves the scale by ~1e-5. (The JAX
    package's Jacobians through log_so3 are compared in
    tests/test_torch_loopclose.py, inside the pose graph.)"""
    J = torch.func.jacfwd(lambda v: t_se3.log_so3(t_se3.exp_so3(v)))(
        torch.zeros(3))
    assert torch.isfinite(J).all()
    np.testing.assert_allclose(J.numpy(), np.eye(3), atol=2e-5)


# ---------------------------------------------------------------------------
# ops/optim


def _quadratic():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(20, 6)).astype(np.float32)
    b = rng.normal(size=(20,)).astype(np.float32)
    return A, b, np.linalg.lstsq(A, b, rcond=None)[0]


def test_gauss_newton_cg_matches_jax():
    A, b, p_ref = _quadratic()
    pj, cj = j_optim.gauss_newton_cg(lambda p: jnp.asarray(A) @ p
                                     - jnp.asarray(b), jnp.zeros(6),
                                     gn_iters=3, cg_iters=12, step_clip=100.0)
    pt, ct = t_optim.gauss_newton_cg(lambda p: _t(A) @ p - _t(b),
                                     torch.zeros(6), gn_iters=3, cg_iters=12,
                                     step_clip=100.0)
    # CG in f32 on a 6-parameter least-squares problem: both at the
    # solution to ~1e-5, the costs to f32 rounding
    np.testing.assert_allclose(pt.numpy(), _np(pj), atol=1e-4)
    np.testing.assert_allclose(pt.numpy(), p_ref, atol=1e-3)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)


def test_gauss_newton_dense_matches_jax():
    A, b, p_ref = _quadratic()

    def j_res(p):
        return (jnp.asarray(A) @ jnp.concatenate([p[0], p[1]])
                - jnp.asarray(b))

    def t_res(p):
        return _t(A) @ torch.cat([p[0], p[1]]) - _t(b)

    pj, cj = j_optim.gauss_newton_dense(j_res, (jnp.zeros(2), jnp.zeros(4)),
                                        gn_iters=3)
    pt, ct = t_optim.gauss_newton_dense(t_res, (torch.zeros(2),
                                                torch.zeros(4)), gn_iters=3)
    got = torch.cat(pt).numpy()
    np.testing.assert_allclose(got, np.concatenate([_np(x) for x in pj]),
                               atol=1e-5)
    np.testing.assert_allclose(got, p_ref, atol=1e-4)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)


# ---------------------------------------------------------------------------
# geometry/pnp


def _pnp_problem(seed, n=120, outliers=0.4, noise_px=0.3):
    r = np.random.default_rng(seed)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    X = np.c_[r.uniform(-6, 6, n), r.uniform(-4, 4, n),
              r.uniform(5, 30, n)]
    a = 0.3
    Rw = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]])
    tw = np.array([1.5, -0.4, 2.0])
    Xw = (X - tw) @ Rw              # camera points X = Rw Xw + tw
    uv = X[:, :2] / X[:, 2:] * 300.0 + np.array([160.0, 120.0])
    uv += r.normal(scale=noise_px, size=uv.shape)
    bad = r.random(n) < outliers
    uv[bad] = r.uniform([0, 0], [W, H], size=(bad.sum(), 2))
    mask = r.random(n) < 0.9
    scores = np.where(bad, r.uniform(0.1, 0.5, n), r.uniform(0.4, 0.9, n))
    return (K, Xw.astype(np.float32), uv.astype(np.float32), mask,
            scores.astype(np.float32), Rw.astype(np.float32),
            tw.astype(np.float32))


def test_dlt_pnp_and_gn_polish_match_jax():
    """The weighted DLT on all points and on two 6-point subsets (weights
    0 elsewhere), batched on the port's side, vmapped on JAX's; then the
    polish from a perturbed start."""
    K, Xw, uv, mask, _, _, _ = _pnp_problem(1, outliers=0.0)
    x = (uv - K[:2, 2]) / np.diag(K)[:2]
    n = Xw.shape[0]
    w = np.stack([mask, np.arange(n) < 6,
                  (np.arange(n) >= 6) & (np.arange(n) < 12)]).astype(
                      np.float32)
    Rj, tj = jax.jit(jax.vmap(j_pnp._dlt_pnp, in_axes=(None, None, 0)))(
        jnp.asarray(Xw), jnp.asarray(x), jnp.asarray(w))
    Rt, tt = t_pnp._dlt_pnp(_t(Xw).expand(3, n, 3), _t(x).expand(3, n, 2),
                            _t(w))
    # a 12x12 inverse iteration in f32 after Hartley normalisation; the
    # 6-point fits are exact minimal solves, more sensitive to rounding
    np.testing.assert_allclose(Rt[0].numpy(), _np(Rj[0]), atol=1e-4)
    np.testing.assert_allclose(tt[0].numpy(), _np(tj[0]), atol=1e-3)
    np.testing.assert_allclose(Rt.numpy(), _np(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), _np(tj), atol=1e-2)
    # polish from a perturbed start
    R0 = (_np(j_se3.exp_so3(jnp.asarray([0.02, -0.01, 0.015])))
          @ _np(Rj[0])).astype(np.float32)
    t0 = (_np(tj[0]) + np.array([0.05, -0.03, 0.1])).astype(np.float32)
    Rj2, tj2 = jax.jit(j_pnp._gn_polish, static_argnames="iters")(
        jnp.asarray(Xw), jnp.asarray(x), jnp.asarray(w[0]), jnp.asarray(R0),
        jnp.asarray(t0), iters=4)
    Rt2, tt2 = t_pnp._gn_polish(_t(Xw), _t(x), _t(w[0]), _t(R0), _t(t0),
                                iters=4)
    np.testing.assert_allclose(Rt2.numpy(), _np(Rj2), atol=1e-5)
    np.testing.assert_allclose(tt2.numpy(), _np(tj2), atol=1e-4)


PNP_KW = dict(threshold_px=1.8, num_hypotheses=64, min_inliers=10)


@jax.jit
def _j_ransac(K, Xw, uv, mask, key, scores):
    return j_pnp.solve_pnp_ransac(K, Xw, uv, mask, key, scores=scores,
                                  **PNP_KW)


@pytest.mark.parametrize("seed,valid", [(2, None), (4, 5)])
def test_solve_pnp_ransac_matches_jax_with_its_draws(seed, valid):
    """With 40 % outliers and score-weighted samples; `valid` 5 keeps fewer
    than 6 points, so every sample ties at -inf on masked points."""
    K, Xw, uv, mask, scores, Rw, tw = _pnp_problem(seed)
    if valid is not None:
        mask = np.arange(mask.shape[0]) < valid
    key = jax.random.PRNGKey(seed)
    rj = _j_ransac(jnp.asarray(K), jnp.asarray(Xw), jnp.asarray(uv),
                   jnp.asarray(mask), key, jnp.asarray(scores))
    g = _np(jax.random.gumbel(key, (PNP_KW["num_hypotheses"], Xw.shape[0]),
                              jnp.float32))
    rt = t_pnp.solve_pnp_ransac(_t(K), _t(Xw), _t(uv), _t(mask), _t(g),
                                scores=_t(scores), **PNP_KW)
    np.testing.assert_array_equal(rt.inliers.numpy(), _np(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers)
    assert bool(rt.ok) == bool(rj.ok)
    if valid is None:
        assert bool(rt.ok)
        # the same sample, refit on the same inliers in another order
        np.testing.assert_allclose(rt.R.numpy(), _np(rj.R), atol=1e-4)
        np.testing.assert_allclose(rt.t.numpy(), _np(rj.t), atol=1e-3)
        np.testing.assert_allclose(rt.R.numpy(), Rw, atol=5e-3)
    else:
        assert np.isfinite(rt.R.numpy()).all()


def test_edge_residual_matches_jax():
    """Pose-graph edge residuals (rotation log, centre difference) on
    random poses and measurements, one of them a near-pi relative turn."""
    from gl_slam_tpu.slam import loopclose as j_lc
    from gl_slam_tpu_torch.slam import loopclose as t_lc

    rng = np.random.default_rng(7)
    C, E = 6, 5
    w = rng.normal(scale=0.5, size=(C, 3)).astype(np.float32)
    w[3] = np.array([0.0, np.pi - 1e-3, 0.0], np.float32)
    Rs = _np(jax.vmap(j_se3.exp_so3)(jnp.asarray(w)))
    ts = rng.normal(scale=5.0, size=(C, 3)).astype(np.float32)
    Zr = _np(jax.vmap(j_se3.exp_so3)(jnp.asarray(
        rng.normal(scale=0.1, size=(E, 3)).astype(np.float32))))
    Zt = rng.normal(size=(E, 3)).astype(np.float32)
    ei = np.array([0, 1, 2, 0, 4], np.int32)
    ej = np.array([1, 2, 3, 5, 5], np.int32)
    ew = np.array([1.0, 1.0, 1.0, 4.0, 0.0], np.float32)
    want = _np(jax.jit(jax.vmap(j_lc._edge_residual,
                                in_axes=(None, None, 0, 0, 0, 0, 0)))(
        jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(ei), jnp.asarray(ej),
        jnp.asarray(Zr), jnp.asarray(Zt), jnp.asarray(ew)))
    got = t_lc._edge_residual(_t(Rs), _t(ts), _t(ei).long(), _t(ej).long(),
                              _t(Zr), _t(Zt), _t(ew)).numpy()
    # f32 products of metre-scale centres; the near-pi rotation residual
    # to the log's 1e-4 there
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert (got[4] == 0).all()
