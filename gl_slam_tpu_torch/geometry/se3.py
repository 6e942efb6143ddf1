"""SO(3)/SE(3) utilities, float32.

Counterpart of gl_slam_tpu/geometry/se3.py (the functions the chunked
tracker and its backend reach). A camera pose (R, t) maps world points to
the camera frame, x_cam = R @ x_world + t. Functions take (..., 3) /
(..., 3, 3) batches where the JAX version is vmapped (`exp_so3` is also the
JAX `exp_so3_batched`, `log_so3` the JAX `log_so3_batched`).
"""

from __future__ import annotations

import math

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


def mv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R @ v for rotations (..., 3, 3) and vectors (..., 3) whose leading
    axes broadcast; without leading axes the plain matrix-vector product."""
    if R.dim() == 2 and v.dim() == 1:
        return R @ v
    return _mv(R, v)


def vm(v: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """v^T R for (..., 3) and (..., 3, 3); without leading axes `v @ R`."""
    if R.dim() == 2 and v.dim() == 1:
        return v @ R
    return (v[..., None, :] @ R)[..., 0, :]


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
    """T_cur = T_rel o T_prev (world->camera poses); leading axes allowed."""
    return R_rel @ R_prev, mv(R_rel, t_prev) + t_rel


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3) (inverse Rodrigues).

    Three regimes, selected without branches: Taylor near theta = 0, the
    antisymmetric-part formula in the middle, and the theta ~ pi branch,
    where the antisymmetric part vanishes and the axis comes from the
    dominant diagonal of (R + I) / 2 with its sign from that part. The
    arccos input stays inside (-1, 1): its derivative is infinite at the
    ends, which would put NaNs into forward-mode Jacobians through
    pose-graph residuals at zero rotation."""
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    trace = torch.clamp(diag.sum(-1), -1.0, 3.0)
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = torch.where(theta < 1e-5, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.sin(theta) + _EPS))
    w_mid = scale[..., None] * v

    # theta ~ pi: R ~ 2 n n^T - I, so n_i^2 = (R_ii + 1) / 2; take the axis
    # candidate anchored at the dominant diagonal entry.
    nsq = torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0)
    anchor = torch.sqrt(torch.clamp_min(nsq, 1e-12))
    sym = 0.5 * (R + R.transpose(-1, -2))
    eye = torch.eye(3, dtype=torch.bool, device=R.device)
    cand = torch.where(eye, anchor[..., :, None],
                       sym / (2.0 * anchor[..., :, None]))
    pick = torch.argmax(nsq, dim=-1)
    n = torch.take_along_dim(cand, pick[..., None, None].expand(
        *pick.shape, 1, 3), dim=-2)[..., 0, :]
    n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1,
                                                     keepdim=True), _EPS)
    # at exactly pi the sign is ambiguous (w and -w are the same rotation)
    sign = torch.where((n * v).sum(-1) >= 0.0, 1.0, -1.0)
    w_pi = (theta * sign)[..., None] * n
    near_pi = theta > math.pi - 1e-2
    return torch.where(near_pi[..., None], w_pi, w_mid)


def rotation_angle_deg(R: torch.Tensor) -> torch.Tensor:
    """Rotation magnitude (...,) in degrees of (..., 3, 3)."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    return torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) * 0.5,
                                                  -1.0, 1.0)))


# Every function here takes leading batch axes, so the JAX package's vmapped
# variants are the functions themselves.
exp_so3_batched = exp_so3
log_so3_batched = log_so3


def pose_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> the 4 x 4 homogeneous matrix."""
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def from_pose_matrix(T: torch.Tensor):
    return T[:3, :3], T[:3, 3]


def translation_direction_angle_deg(t1: torch.Tensor,
                                    t2: torch.Tensor) -> torch.Tensor:
    """Angle between two translation directions, degrees."""
    n1 = t1 / (torch.linalg.vector_norm(t1) + _EPS)
    n2 = t2 / (torch.linalg.vector_norm(t2) + _EPS)
    return torch.rad2deg(torch.arccos(torch.clamp(torch.dot(n1, n2),
                                                  -1.0, 1.0)))
