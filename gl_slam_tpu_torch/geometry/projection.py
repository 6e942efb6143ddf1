"""Pinhole projection and reprojection residuals — batched, masked.

Counterpart of gl_slam_tpu/geometry/projection.py. Runs in full float32:
the port switches TF32 off for the whole process when an entry point selects
the card (ops/precision.py), so `pts @ R.T` never loses digits.

Every function that reads K takes a K (3, 3) shared by all streams, or
K (S, 3, 3) with one row per stream of a stream-batched state, whose
stream axis leads every tensor (`per_stream` lines a per-stream value up
with it).
"""

from __future__ import annotations

import torch


def per_stream(v: torch.Tensor, K: torch.Tensor, rank: int) -> torch.Tensor:
    """A value derived from K, one per stream (S, *rest) when K is
    (S, 3, 3), shaped (S, 1, ..., 1, *rest) with `rank` dimensions in all,
    so that it broadcasts against a tensor of that rank whose leading axis
    is the stream axis: per-point rows (S, N), stacked pose hypotheses
    (S, h, N), K itself against (S, ..., 3, n) for a product. Under a K
    (3, 3) shared by all streams `v` is returned as it is."""
    if K.dim() == 2:
        return v
    s = K.dim() - 2
    return v.reshape(v.shape[:s] + (1,) * (rank - v.dim()) + v.shape[s:])


def intrinsics(K: torch.Tensor, like: torch.Tensor):
    """(fx, fy, cx, cy) of K, each broadcasting against `like` (0-d
    tensors under a shared K)."""
    return tuple(per_stream(v, K, like.dim()) for v in (
        K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]))


def project(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
            pts_w: torch.Tensor):
    """Project (..., N, 3) world points at poses R (..., 3, 3), t (..., 3):
    (uv (..., N, 2), depth (..., N), in_front (..., N))."""
    pc = pts_w @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    in_front = z > 1e-6
    zs = torch.where(in_front, z, 1.0)
    x = pc[..., 0] / zs
    y = pc[..., 1] / zs
    fx, fy, cx, cy = intrinsics(K, x)
    uv = torch.stack([fx * x + cx, fy * y + cy], dim=-1)
    return uv, z, in_front


def reprojection_error(K, R, t, pts_w, uv_obs):
    """Per-point reprojection error in pixels (N,). Behind-camera -> +inf."""
    uv, _, in_front = project(K, R, t, pts_w)
    err = torch.linalg.vector_norm(uv - uv_obs, dim=-1)
    return torch.where(in_front, err, float("inf"))


def in_image(uv: torch.Tensor, height: int, width: int,
             margin: float = 0.0) -> torch.Tensor:
    return ((uv[..., 0] >= margin) & (uv[..., 0] < width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < height - margin))


def normalize_points(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixel coords (..., 2) -> normalized camera coords using K^{-1}."""
    fx, fy, cx, cy = intrinsics(K, uv[..., 0])
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y], dim=-1)


def cauchy_weight(r2: torch.Tensor, scale: float) -> torch.Tensor:
    """IRLS weight of the Cauchy loss rho(s) = c^2 log(1 + s/c^2)."""
    c2 = scale * scale
    return 1.0 / (1.0 + r2 / c2)
