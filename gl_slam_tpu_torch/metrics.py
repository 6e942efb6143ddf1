"""Trajectory / map quality metrics, on the host.

The port's own copy of `gl_slam_tpu/metrics.py` (numpy only): per-frame GT
pose errors (rotation in degrees, translation direction in degrees,
translation magnitude in m), ATE-RMSE with Horn/Umeyama alignment, camera
centres and reprojection-error statistics. They run on trajectories after
a run, not in the tracking loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class PoseErrors(NamedTuple):
    rot_deg: np.ndarray     # (F,)
    t_dir_deg: np.ndarray   # (F,)
    t_mag: np.ndarray       # (F,)


def per_frame_pose_errors(R_est: np.ndarray, t_est: np.ndarray,
                          R_gt: np.ndarray, t_gt: np.ndarray) -> PoseErrors:
    """Per-frame absolute pose errors vs GT (both world->camera)."""
    F = len(R_est)
    rot = np.zeros(F)
    tdir = np.zeros(F)
    tmag = np.zeros(F)
    for i in range(F):
        dR = R_gt[i].T @ R_est[i]
        rot[i] = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        c_est = -R_est[i].T @ t_est[i]
        c_gt = -R_gt[i].T @ t_gt[i]
        tmag[i] = np.linalg.norm(c_est - c_gt)
        n_est = np.linalg.norm(c_est) + 1e-12
        n_gt = np.linalg.norm(c_gt) + 1e-12
        tdir[i] = np.degrees(np.arccos(np.clip(
            np.dot(c_est / n_est, c_gt / n_gt), -1, 1)))
    return PoseErrors(rot_deg=rot, t_dir_deg=tdir, t_mag=tmag)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares similarity transform aligning src -> dst (both (N,3)).

    Returns (s, R, t) with dst ~= s * R @ src + t."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(S) @ D) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(centers_est: np.ndarray, centers_gt: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE over camera centres (N,3)."""
    if align:
        s, R, t = umeyama_alignment(centers_est, centers_gt, with_scale)
        aligned = (s * (R @ centers_est.T)).T + t
    else:
        aligned = centers_est
    err = np.linalg.norm(aligned - centers_gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def camera_centers(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(F,3,3),(F,3) world->camera poses -> (F,3) camera centres."""
    return -np.einsum('fij,fj->fi', np.transpose(R, (0, 2, 1)), t)


def reprojection_stats(errors: np.ndarray,
                       valid: Optional[np.ndarray] = None) -> dict:
    """Mean / max / min reprojection error in px, and the count."""
    e = errors[valid] if valid is not None else errors
    if len(e) == 0:
        return {"mean_px": float("nan"), "max_px": float("nan"),
                "min_px": float("nan"), "count": 0}
    return {"mean_px": float(e.mean()), "max_px": float(e.max()),
            "min_px": float(e.min()), "count": int(len(e))}
