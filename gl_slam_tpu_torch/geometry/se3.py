"""SO(3)/SE(3) utilities, float32.

Counterpart of gl_slam_tpu/geometry/se3.py (the functions the chunked
tracker reaches). A camera pose (R, t) maps world points to the camera
frame, x_cam = R @ x_world + t. Functions take (..., 3) / (..., 3, 3)
batches where the JAX version is vmapped.
"""

from __future__ import annotations

import torch

from ..ops import smallmat

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrices of (..., 3) vectors -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation (..., 3, 3)."""
    theta2 = (w * w).sum(-1)[..., None, None]
    theta = torch.sqrt(theta2 + _EPS)
    use_taylor = theta2 < 1e-8
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * W + b * (W @ W)


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation via the closed-form SVD with det correction."""
    U, _, Vt = smallmat.svd3(M)
    d = torch.sign(smallmat.det3x3(U @ Vt))
    D = torch.ones(M.shape[:-2] + (3,), dtype=M.dtype, device=M.device)
    D = torch.cat([D[..., :2], d[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vt


def chain_relative(R_prev, t_prev, R_rel, t_rel):
    """T_cur = T_rel o T_prev (world->camera poses)."""
    return R_rel @ R_prev, R_rel @ t_prev + t_rel
