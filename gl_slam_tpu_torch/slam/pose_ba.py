"""Pose-only bundle adjustment: robust 6-DoF Levenberg-Marquardt.

Counterpart of gl_slam_tpu/slam/pose_ba.py. Points are held fixed and the
pose is refined against Cauchy-weighted pixel residuals through the 6x6
normal equations. The JAX version stops a start early (two iterations
without relative improvement) by freezing it; under `vmap` a frozen lane
simply keeps its carry while the loop runs on. This port runs the full
iteration budget with the same frozen-lane select, which gives the same
result as the early exit without reading anything back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import projection, se3
from ..ops import smallmat


class PoseBAResult(NamedTuple):
    R: torch.Tensor            # (..., 3, 3)
    t: torch.Tensor            # (..., 3)
    final_cost: torch.Tensor   # (...,)
    num_used: torch.Tensor     # (...,) int32


def _residuals_jacobian(K, R, t, pts, uv):
    """Residuals (..., N, 2), Jacobian wrt a left se(3) increment
    (..., N, 2, 6) and the behind-camera mask, for poses (..., 3, 3)."""
    pc = pts @ R.transpose(-1, -2) + t[..., None, :]
    fx, fy, cx, cy = projection.intrinsics(K, pc[..., 0])
    z = torch.clamp_min(pc[..., 2], 1e-6)
    inv_z = 1.0 / z
    u = fx * pc[..., 0] * inv_z + cx
    v = fy * pc[..., 1] * inv_z + cy
    r = torch.stack([u, v], dim=-1) - uv
    zero = torch.zeros_like(z)
    J_pc = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * pc[..., 0] * inv_z ** 2], -1),
        torch.stack([zero, fy * inv_z, -fy * pc[..., 1] * inv_z ** 2], -1),
    ], dim=-2)                                            # (..., N, 2, 3)
    hat_pc = se3.hat(pc)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device).expand_as(hat_pc)
    J = J_pc @ torch.cat([-hat_pc, eye], dim=-1)          # (..., N, 2, 6)
    return r, J, pc[..., 2] <= 1e-6


def _lm(K, R, t, pts, uv, maskf, iters: int, cauchy_scale: float,
        lm_lambda_init: float):
    c2 = cauchy_scale * cauchy_scale
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)

    def cost_of(Rc, tc):
        r, _, behind = _residuals_jacobian(K, Rc, tc, pts, uv)
        rho = c2 * torch.log1p((r * r).sum(-1) / c2)
        rho = torch.where(behind, c2 * 10.0, rho)
        return (maskf * rho).sum(-1)

    cost = cost_of(R, t)
    lam = torch.full_like(cost, lm_lambda_init)
    stall = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
    for _ in range(iters):
        done = stall >= 2
        r, J, behind = _residuals_jacobian(K, R, t, pts, uv)
        w = projection.cauchy_weight((r * r).sum(-1), cauchy_scale) * maskf
        w = torch.where(behind, 0.0, w)
        Jw = J * w[..., None, None]
        H = torch.einsum('...nij,...nik->...jk', Jw, J)
        g = torch.einsum('...nij,...ni->...j', Jw, r)
        Hd = H + lam[..., None, None] * torch.diag_embed(
            torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-9 * eye6
        dx = -smallmat.cholesky_solve(Hd, g)
        dR = se3.exp_so3(dx[..., :3])
        R_new = dR @ R
        t_new = (dR @ t[..., None])[..., 0] + dx[..., 3:]
        new_cost = cost_of(R_new, t_new)
        accept = (new_cost < cost) & ~done
        improved = accept & (cost - new_cost > 1e-5 * cost)
        stall = torch.where(done, stall,
                            torch.where(improved, 0, stall + 1))
        R = torch.where(accept[..., None, None], R_new, R)
        t = torch.where(accept[..., None], t_new, t)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(done, lam, torch.clamp(
            torch.where(accept, lam * 0.1, lam * 10.0), 1e-9, 1e6))
    return R, t, cost


def pose_only_ba_multi(K, R0s, t0s, pts_w, uv, mask, iters: int = 30,
                       cauchy_scale: float = 1.0,
                       lm_lambda_init: float = 1e-4, coarse_iters: int = 0,
                       coarse_scale_mult: float = 8.0,
                       point_weights: Optional[torch.Tensor] = None
                       ) -> PoseBAResult:
    """Refine starts R0s (..., 3, 3), t0s (..., 3) against fixed points
    pts_w (N, 3) observed at uv (N, 2) (mask (N,)). `coarse_iters` > 0
    prepends that many iterations at `cauchy_scale * coarse_scale_mult`;
    `final_cost` is at the fine scale. `point_weights` (N,) multiplies the
    robust weights and the cost.

    Under a stream axis the points carry it too, (S, N, 3), and the starts
    are (S, 3, 3) or, with a start axis behind it, (S, starts, 3, 3)."""
    dt = torch.float32
    if pts_w.dim() > 2 and R0s.dim() > pts_w.dim():
        # a start axis behind the stream axis: the points broadcast over it
        pts_w, uv = pts_w.unsqueeze(-3), uv.unsqueeze(-3)
        mask = mask.unsqueeze(-2)
        if point_weights is not None:
            point_weights = point_weights.unsqueeze(-2)
    pts_w, uv = pts_w.to(dt), uv.to(dt)
    maskf = mask.to(dt)
    if point_weights is not None:
        maskf = maskf * point_weights.to(dt)
    R, t = R0s.to(dt), t0s.to(dt)
    if coarse_iters > 0:
        R, t, _ = _lm(K, R, t, pts_w, uv, maskf, coarse_iters,
                      cauchy_scale * coarse_scale_mult, lm_lambda_init)
    R, t, cost = _lm(K, R, t, pts_w, uv, maskf, iters, cauchy_scale,
                     lm_lambda_init)
    n_used = mask.to(torch.int32).sum(-1, dtype=torch.int32)
    return PoseBAResult(R=R, t=t, final_cost=cost,
                        num_used=n_used.expand(cost.shape))


def pose_only_ba(K, R0, t0, pts_w, uv, mask, iters: int = 30,
                 cauchy_scale: float = 1.0, lm_lambda_init: float = 1e-4,
                 coarse_iters: int = 0, coarse_scale_mult: float = 8.0,
                 point_weights: Optional[torch.Tensor] = None
                 ) -> PoseBAResult:
    """One start (3, 3)/(3,) — `pose_only_ba_multi` without a start axis."""
    return pose_only_ba_multi(K, R0, t0, pts_w, uv, mask, iters=iters,
                              cauchy_scale=cauchy_scale,
                              lm_lambda_init=lm_lambda_init,
                              coarse_iters=coarse_iters,
                              coarse_scale_mult=coarse_scale_mult,
                              point_weights=point_weights)
