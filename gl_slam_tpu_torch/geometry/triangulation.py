"""Batched two-view triangulation + cheirality/depth/reprojection filters.

Counterpart of gl_slam_tpu/geometry/triangulation.py: the f32-robust
ray-depth solve (point constrained to ray 0, depth from the view-1
algebraic residual, then Gauss-Newton on the true pixel residual) and the
closed-form midpoint triangulation used by the essential cheirality vote.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import projection


class TriangulationResult(NamedTuple):
    points: torch.Tensor   # (N,3) world points (garbage where ~valid)
    valid: torch.Tensor    # (N,) bool — passed all filters
    errors: torch.Tensor   # (N,) max reprojection error over the two views


def _ray_depth_batched(K, R0, t0, R1, t1, uv0, uv1, newton_iters: int = 2):
    x0 = projection.normalize_points(K, uv0)
    ray0 = torch.cat([x0, torch.ones_like(x0[:, :1])], dim=1)     # (N,3)
    R_rel = R1 @ R0.T
    t_rel = t1 - R_rel @ t0
    h_c = K @ t_rel                                               # (3,)
    h_d = K @ (R_rel @ ray0.T)                                    # (3,N)
    r0 = torch.stack([uv1[:, 0] * h_c[2] - h_c[0],
                      uv1[:, 1] * h_c[2] - h_c[1]], dim=1)
    r1 = torch.stack([uv1[:, 0] * h_d[2] - h_d[0],
                      uv1[:, 1] * h_d[2] - h_d[1]], dim=1)
    denom = (r1 * r1).sum(1)
    s = -(r0 * r1).sum(1) / torch.clamp_min(denom, 1e-20)
    for _ in range(newton_iters):
        p = h_d * s[None, :] + h_c[:, None]
        z = torch.where(p[2].abs() < 1e-12, 1e-12, p[2])
        ex = p[0] / z - uv1[:, 0]
        ey = p[1] / z - uv1[:, 1]
        gx = (h_d[0] * z - p[0] * h_d[2]) / (z * z)
        gy = (h_d[1] * z - p[1] * h_d[2]) / (z * z)
        g2 = gx * gx + gy * gy
        s = s - (ex * gx + ey * gy) / torch.clamp_min(g2, 1e-20)
    X_cam0 = s[:, None] * ray0
    return (X_cam0 - t0[None, :]) @ R0


def triangulate(K, R0, t0, R1, t1, uv0, uv1, mask=None,
                max_depth: float = 100.0, max_reproj_px: float = 0.5,
                min_parallax_deg: float = 0.0) -> TriangulationResult:
    """Triangulate (N,) correspondences between two cameras and filter:
    positive depth in both, camera-0 depth < max_depth, reprojection error
    <= max_reproj_px in both views, optional minimum ray angle."""
    pts = _ray_depth_batched(K, R0, t0, R1, t1, uv0, uv1)
    _, z0, front0 = projection.project(K, R0, t0, pts)
    _, z1, front1 = projection.project(K, R1, t1, pts)
    e0 = projection.reprojection_error(K, R0, t0, pts, uv0)
    e1 = projection.reprojection_error(K, R1, t1, pts, uv1)
    err = torch.maximum(e0, e1)
    valid = front0 & front1 & (z0 < max_depth) & (err <= max_reproj_px)
    if min_parallax_deg > 0.0:
        c0 = -t0 @ R0
        c1 = -t1 @ R1
        r0 = pts - c0
        r1 = pts - c1
        cosang = (r0 * r1).sum(1) / torch.clamp_min(
            torch.linalg.vector_norm(r0, dim=1)
            * torch.linalg.vector_norm(r1, dim=1), 1e-12)
        valid = valid & (cosang < math.cos(math.radians(min_parallax_deg)))
    if mask is not None:
        valid = valid & mask
    valid = valid & torch.isfinite(pts).all(dim=-1)
    return TriangulationResult(points=pts, valid=valid, errors=err)


def triangulate_midpoint(K, R0, t0, R1, t1, uv0, uv1):
    """Closed-form midpoint triangulation. Poses (..., 3, 3)/(..., 3) and
    pixels (..., N, 2) broadcast against each other; returns (..., N, 3)
    world points."""
    x0 = projection.normalize_points(K, uv0)
    x1 = projection.normalize_points(K, uv1)
    d0 = torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1) @ R0
    d1 = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1) @ R1
    c0 = (-t0[..., None, :] @ R0)                  # (..., 1, 3)
    c1 = (-t1[..., None, :] @ R1)
    a = (d0 * d0).sum(-1)
    b = (d0 * d1).sum(-1)
    c = (d1 * d1).sum(-1)
    w = c1 - c0
    d = (d0 * w).sum(-1)
    e = (d1 * w).sum(-1)
    denom = a * c - b * b
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    s = (c * d - b * e) / denom
    tt = (b * d - a * e) / denom
    p0 = c0 + s[..., None] * d0
    p1 = c1 + tt[..., None] * d1
    return 0.5 * (p0 + p1)
