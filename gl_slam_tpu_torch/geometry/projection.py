"""Pinhole projection and reprojection residuals — batched, masked.

Counterpart of gl_slam_tpu/geometry/projection.py. Runs in full float32:
the port switches TF32 off for the whole process when an entry point selects
the card (ops/precision.py), so `pts @ R.T` never loses digits.
"""

from __future__ import annotations

import torch


def project(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
            pts_w: torch.Tensor):
    """Project (N,3) world points: (uv (N,2), depth (N,), in_front (N,))."""
    pc = pts_w @ R.T + t
    z = pc[:, 2]
    in_front = z > 1e-6
    zs = torch.where(in_front, z, 1.0)
    x = pc[:, 0] / zs
    y = pc[:, 1] / zs
    uv = torch.stack([K[0, 0] * x + K[0, 2], K[1, 1] * y + K[1, 2]], dim=-1)
    return uv, z, in_front


def reprojection_error(K, R, t, pts_w, uv_obs):
    """Per-point reprojection error in pixels (N,). Behind-camera -> +inf."""
    uv, _, in_front = project(K, R, t, pts_w)
    err = torch.linalg.vector_norm(uv - uv_obs, dim=-1)
    return torch.where(in_front, err, float("inf"))


def in_image(uv: torch.Tensor, height: int, width: int,
             margin: float = 0.0) -> torch.Tensor:
    return ((uv[:, 0] >= margin) & (uv[:, 0] < width - margin)
            & (uv[:, 1] >= margin) & (uv[:, 1] < height - margin))


def normalize_points(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixel coords (..., 2) -> normalized camera coords using K^{-1}."""
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y], dim=-1)


def cauchy_weight(r2: torch.Tensor, scale: float) -> torch.Tensor:
    """IRLS weight of the Cauchy loss rho(s) = c^2 log(1 + s/c^2)."""
    c2 = scale * scale
    return 1.0 / (1.0 + r2 / c2)
