"""Essential-matrix RANSAC + pose recovery over fixed-shape batches.

Counterpart of gl_slam_tpu/geometry/essential.py: a fixed number of 8-point
hypotheses scored by truncated Sampson error, the top-6 plus a
forward-motion prior polished by Gauss-Newton on the truncated Sampson cost
over the 5-DoF pose, selection by cost plus a cheirality penalty, and a
final sign vote on t.

Randomness is an argument: `u` holds the (..., hypotheses, 8) uniform draws
that the JAX version takes from `jax.random.uniform(key, (H, 8))`, so a
caller (or a test) decides where they come from. Every function takes
leading batch dimensions (the chunk's consecutive pairs) where the JAX
version is vmapped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from ..ops import smallmat
from ..ops.select import topk_stable
from . import projection, triangulation


class EssentialResult(NamedTuple):
    R: torch.Tensor            # (..., 3, 3)
    t: torch.Tensor            # (..., 3) unit norm
    E: torch.Tensor            # (..., 3, 3)
    inliers: torch.Tensor      # (..., N) bool
    num_inliers: torch.Tensor  # (...,) int32
    ok: torch.Tensor           # (...,) bool


def _hat(t: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(t[..., 0])
    return torch.stack([torch.stack([z, -t[..., 2], t[..., 1]], -1),
                        torch.stack([t[..., 2], z, -t[..., 0]], -1),
                        torch.stack([-t[..., 1], t[..., 0], z], -1)], -2)


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _fit_eight_point(x0, x1, w):
    """Weighted 8-point fit with the (1,1,0) constraint: x0/x1 (..., 8, 2),
    w (..., 8) -> E (..., 3, 3)."""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    A = torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0,
                     torch.ones_like(u0)], dim=-1)
    M = (A * w[..., None]).transpose(-1, -2) @ A
    E = smallmat.smallest_eigvec(M).unflatten(-1, (3, 3))
    U, _, Vt = smallmat.svd3(E)
    D = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * D) @ Vt


def _sampson_parts(E, x0, x1):
    p0, p1 = _homog(x0), _homog(x1)
    Ep0 = p0 @ E.transpose(-1, -2)      # rows: E @ p0
    Etp1 = p1 @ E                       # rows: E^T @ p1
    num = (p1 * Ep0).sum(-1)
    den = Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2 + Etp1[..., 0] ** 2 \
        + Etp1[..., 1] ** 2
    return num, torch.clamp_min(den, 1e-12)


def _sampson_error_sq(E, x0, x1):
    """Squared Sampson distance: E (..., 3, 3), x (..., N, 2) -> (..., N)."""
    num, den = _sampson_parts(E, x0, x1)
    return num ** 2 / den


def _sampson_signed(E, x0, x1):
    num, den = _sampson_parts(E, x0, x1)
    return num * torch.rsqrt(den)


def _tangent_basis(t):
    """(..., 3, 2) orthonormal basis of the plane perpendicular to unit t."""
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    e1 = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    a = torch.where((t[..., 0].abs() < 0.9)[..., None], e0, e1)
    b1 = torch.linalg.cross(t, a, dim=-1)
    b1 = b1 / torch.clamp_min(torch.linalg.vector_norm(b1, dim=-1,
                                                       keepdim=True), 1e-12)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    return torch.stack([b1, b2], dim=-1)


def _exp_so3_local(w):
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2 + 1e-20)
    W = _hat(w)
    a = torch.where(th2 < 1e-10, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(th2 < 1e-10, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th)) / torch.clamp_min(th2, 1e-20))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * W + b * (W @ W)


def _unit(t):
    return t / torch.clamp_min(torch.linalg.vector_norm(t, dim=-1,
                                                        keepdim=True), 1e-12)


def refine_pose_sampson(x0, x1, maskf, R, t, thr2, iters: int):
    """Gauss-Newton on the truncated Sampson cost over the 5-DoF pose (so3
    delta on R, 2-DoF tangent delta on the unit t), accepting only steps
    that lower the cost. x0/x1 (..., N, 2) broadcast against R (..., 3, 3).
    The (N, 5) Jacobian is forward-mode AD, as `jax.jacfwd` in the JAX
    version."""
    eye5 = torch.eye(5, dtype=R.dtype, device=R.device)

    def cost(Rc, tc):
        r = _sampson_signed(_hat(tc) @ Rc, x0, x1)
        return r, (torch.minimum(r * r, thr2) * maskf).sum(-1)

    _, prev = cost(R, t)
    for _ in range(iters):
        B = _tangent_basis(t)

        def r_of(w, R=R, t=t, B=B):
            Rn = _exp_so3_local(w[..., :3]) @ R
            tn = _unit(t + (B @ w[..., 3:, None])[..., 0])
            return _sampson_signed(_hat(tn) @ Rn, x0, x1)

        w0 = torch.zeros(R.shape[:-2] + (5,), dtype=R.dtype, device=R.device)
        cols = []
        for j in range(5):
            r0, dr = jvp(r_of, (w0,), (eye5[j].expand_as(w0),))
            cols.append(dr)
        J = torch.stack(cols, dim=-1)                     # (..., N, 5)
        w_rob = maskf * (r0 * r0 < thr2).to(R.dtype)
        Jw = J * w_rob[..., None]
        A = Jw.transpose(-1, -2) @ J + 1e-10 * eye5
        g = (Jw.transpose(-1, -2) @ r0[..., None])[..., 0]
        dw = -smallmat.cholesky_solve(A, g)
        R_new = _exp_so3_local(dw[..., :3]) @ R
        t_new = _unit(t + (B @ dw[..., 3:, None])[..., 0])
        _, c_new = cost(R_new, t_new)
        accept = c_new < prev
        R = torch.where(accept[..., None, None], R_new, R)
        t = torch.where(accept[..., None], t_new, t)
        prev = torch.where(accept, c_new, prev)
    return R, t


def decompose_essential(E):
    """E (..., 3, 3) -> 4 candidates (R1,t), (R1,-t), (R2,t), (R2,-t) as
    (..., 4, 3, 3) and (..., 4, 3)."""
    U, _, Vt = smallmat.svd3(E)
    U = U * torch.sign(smallmat.det3x3(U))[..., None, None]
    Vt = Vt * torch.sign(smallmat.det3x3(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def _cheirality_votes(K, Rs, ts, uv0, uv1, weights):
    """Weighted count of midpoint-triangulated points in front of both
    cameras. Rs (..., C, 3, 3), ts (..., C, 3); uv (..., N, 2) and weights
    (..., N) broadcast against the candidate axis -> (..., C)."""
    eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
    zero = torch.zeros(3, dtype=Rs.dtype, device=Rs.device)
    pts = triangulation.triangulate_midpoint(K, eye, zero, Rs, ts,
                                             uv0[..., None, :, :],
                                             uv1[..., None, :, :])
    z0 = pts[..., 2]
    z1 = (pts @ Rs.transpose(-1, -2) + ts[..., None, :])[..., 2]
    front = (z0 > 0).to(Rs.dtype) * (z1 > 0).to(Rs.dtype)
    return (weights[..., None, :] * front).sum(-1)


def _take(x, idx):
    """x (..., C, *rest), idx (...,) -> x[..., idx, *rest]."""
    rest = x.shape[idx.dim() + 1:]
    i = idx.reshape(idx.shape + (1,) * (len(rest) + 1)).expand(
        idx.shape + (1,) + rest)
    return torch.gather(x, idx.dim(), i).squeeze(idx.dim())


def estimate_essential(K, uv0, uv1, mask, u, threshold_px: float = 0.5,
                       num_hypotheses: int = 512, refine_iters: int = 10,
                       min_inliers: int = 15) -> EssentialResult:
    """RANSAC over padded correspondences uv0/uv1 (..., N, 2), mask
    (..., N); `u` (..., num_hypotheses, 8) uniform draws in [0, 1)."""
    dt = torch.float32
    uv0, uv1 = uv0.to(dt), uv1.to(dt)
    N = uv0.shape[-2]
    lead = uv0.shape[:-2]
    if u.shape != lead + (num_hypotheses, 8):
        raise ValueError(f"draws of shape {tuple(u.shape)}, expected "
                         f"{tuple(lead + (num_hypotheses, 8))}")
    x0 = projection.normalize_points(K, uv0)
    x1 = projection.normalize_points(K, uv1)
    f = 0.5 * (K[0, 0] + K[1, 1])
    thr = threshold_px / f
    thr2 = thr * thr
    maskf = mask.to(dt)

    # Hypothesis sampling: inverse CDF over the valid prefix count.
    csum = torch.cumsum(mask.to(torch.int32), dim=-1, dtype=torch.int32)
    num_valid = csum[..., -1]
    targets = (u.to(dt) * num_valid.to(dt)[..., None, None]).to(torch.int32)
    idx = torch.searchsorted(csum, (targets + 1).flatten(-2), right=False)
    idx = torch.clamp(idx, 0, N - 1).long()                  # (..., H*8)
    sx0 = torch.gather(x0, -2, idx[..., None].expand(*idx.shape, 2))
    sx1 = torch.gather(x1, -2, idx[..., None].expand(*idx.shape, 2))
    sx0 = sx0.unflatten(-2, (num_hypotheses, 8))
    sx1 = sx1.unflatten(-2, (num_hypotheses, 8))
    Es = _fit_eight_point(sx0, sx1, torch.ones_like(sx0[..., 0]))

    # Scoring: truncated squared Sampson error, padded rows at the cap.
    x0h, x1h = x0[..., None, :, :], x1[..., None, :, :]
    errs = _sampson_error_sq(Es, x0h, x1h)                   # (..., H, N)
    errs = torch.where(mask[..., None, :], errs, thr2)
    scores = torch.minimum(errs, thr2).sum(-1)

    # Multi-start local optimization from the top-6 hypotheses plus the
    # forward-motion prior (R = I, t = +z).
    S = 6
    _, top_i = topk_stable(-scores, S)
    E_c = torch.gather(Es, -3, top_i[..., None, None].expand(
        *top_i.shape, 3, 3))                                 # (..., S, 3, 3)
    e2b = _sampson_error_sq(E_c, x0h, x1h)
    w = maskf[..., None, :] * (e2b < thr2).to(dt)            # (..., S, N)
    Rs, ts = decompose_essential(E_c)                        # (..., S, 4, ...)
    votes = _cheirality_votes(K, Rs, ts, uv0[..., None, :, :],
                              uv1[..., None, :, :], w)       # (..., S, 4)
    pick = torch.argmax(votes, dim=-1)
    R0s, t0s = _take(Rs, pick), _take(ts, pick)
    R0s = torch.cat([R0s, torch.eye(3, dtype=dt, device=R0s.device).expand(
        *lead, 1, 3, 3)], dim=-3)
    t0s = torch.cat([t0s, torch.tensor([0.0, 0.0, 1.0], dtype=dt,
                                       device=t0s.device).expand(*lead, 1, 3)],
                    dim=-2)

    R_s, t_s = refine_pose_sampson(x0h, x1h, maskf[..., None, :], R0s, t0s,
                                   thr2, refine_iters)
    e2 = _sampson_error_sq(_hat(t_s) @ R_s, x0h, x1h)        # (..., S+1, N)
    inl_w = maskf[..., None, :] * (e2 < thr2).to(dt)
    cheir = _cheirality_votes(K, R_s[..., None, :, :], t_s[..., None, :],
                              uv0[..., None, :, :], uv1[..., None, :, :],
                              inl_w)[..., 0]
    cost = torch.minimum(torch.where(mask[..., None, :], e2, thr2),
                         thr2).sum(-1) + thr2 * (inl_w.sum(-1) - cheir)
    best = torch.argmin(cost, dim=-1)
    R, t = _take(R_s, best), _take(t_s, best)
    E = _hat(t) @ R

    e2 = _sampson_error_sq(E, x0, x1)
    inliers = mask & (e2 < thr2)
    num_inliers = inliers.to(torch.int32).sum(-1, dtype=torch.int32)
    votes2 = _cheirality_votes(K, torch.stack([R, R], dim=-3),
                               torch.stack([t, -t], dim=-2), uv0, uv1,
                               inliers.to(dt))
    t = torch.where((votes2[..., 1] > votes2[..., 0])[..., None], -t, t)
    return EssentialResult(R=R, t=t, E=E, inliers=inliers,
                           num_inliers=num_inliers,
                           ok=num_inliers >= min_inliers)
