"""SO(3)/SE(3) utilities, float32.

Counterpart of gl_slam_tpu/geometry/se3.py (the functions the chunked
tracker and its backend reach). A camera pose (R, t) maps world points to
the camera frame, x_cam = R @ x_world + t. Functions take (..., 3) /
(..., 3, 3) batches where the JAX version is vmapped (`exp_so3` is also the
JAX `exp_so3_batched`).
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


def _mv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (R @ v[..., None])[..., 0]


def compose(R1, t1, R2, t2):
    """(R1,t1) o (R2,t2): apply (R2,t2) first, then (R1,t1)."""
    return R1 @ R2, _mv(R1, t2) + t1


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def delta_pose(R_pre, t_pre, R_post, t_post):
    """Rigid delta T_post o T_pre^{-1} with SO(3)-projected rotation: the
    correction applied to keyframes and points created while a BA ran on a
    snapshot."""
    Ri, _ = inverse(R_pre, t_pre)
    dR = project_to_so3(R_post @ Ri)
    return dR, t_post - _mv(dR, t_pre)


def apply_to_points(R, t, pts):
    """Transform (N,3) points: R @ p + t."""
    return pts @ R.transpose(-1, -2) + t


def chain_relative(R_prev, t_prev, R_rel, t_rel):
    """T_cur = T_rel o T_prev (world->camera poses)."""
    return R_rel @ R_prev, R_rel @ t_prev + t_rel
