"""PnP RANSAC: batched 6-point DLT hypotheses + Gauss-Newton polish.

Counterpart of gl_slam_tpu/geometry/pnp.py. A fixed bank of minimal
hypotheses (6-point DLT), truncated-quadratic scoring, then iterative refit
on the inliers. Every function takes leading batch dimensions where the
JAX version is vmapped (the loop detector's candidates).

Randomness is an argument: `gumbel` holds the (..., hypotheses, N) Gumbel
draws that the JAX version takes from `jax.random.gumbel(key, (H, N))`, so
a caller (or a test) decides where they come from. Each hypothesis samples
the 6 points of largest score-biased, masked noise; with fewer than 6
valid points the masked ones tie at -inf and the sample takes the lowest
indices among them, as `lax.top_k` does (`topk_stable`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops import smallmat
from ..ops.select import topk_stable
from . import projection, se3


class PnPResult(NamedTuple):
    R: torch.Tensor            # (..., 3, 3) world->camera
    t: torch.Tensor            # (..., 3)
    inliers: torch.Tensor      # (..., N) bool
    num_inliers: torch.Tensor  # (...,) int32
    ok: torch.Tensor           # (...,) bool


def _mv(R, v):
    return (R @ v[..., None])[..., 0]


def _dlt_pnp(pts: torch.Tensor, x: torch.Tensor, w: torch.Tensor):
    """Weighted DLT PnP in normalized coordinates: pts (..., M, 3) world
    points, x (..., M, 2) normalized image points, w (..., M) weights ->
    (R (..., 3, 3), t (..., 3)). Solves x ~ P [X; 1] for P = [R | t] up to
    scale, projects the 3x3 part to SO(3) and rescales t with it.

    Hartley normalisation: both point sets are centred and scaled to RMS
    sqrt(3) / sqrt(2) first. Without it the DLT Gram mixes world
    coordinates of O(10-100 m) with normalized image coordinates of
    O(0.5), a condition number of ~1e5-1e8 that the f32 inverse iteration
    survives only sometimes: RANSAC on the JAX side succeeded for some
    draws and collapsed to ~0 inliers for others on the same data."""
    dt, dev = pts.dtype, pts.device
    wsum = torch.clamp_min(w.sum(-1), 1e-9)
    c3 = (pts * w[..., None]).sum(-2) / wsum[..., None]
    d3 = torch.sqrt((w * ((pts - c3[..., None, :]) ** 2).sum(-1)).sum(-1)
                    / wsum)
    s3 = math.sqrt(3.0) / torch.clamp_min(d3, 1e-9)
    c2 = (x * w[..., None]).sum(-2) / wsum[..., None]
    d2 = torch.sqrt((w * ((x - c2[..., None, :]) ** 2).sum(-1)).sum(-1)
                    / wsum)
    s2 = math.sqrt(2.0) / torch.clamp_min(d2, 1e-9)
    pn = (pts - c3[..., None, :]) * s3[..., None, None]
    xn = (x - c2[..., None, :]) * s2[..., None, None]

    X, Y, Z = pn[..., 0], pn[..., 1], pn[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    one = torch.ones_like(X)
    zero = torch.zeros_like(X)
    # two rows per point of the DLT system A p = 0, p = vec(P) (12,)
    r1 = torch.stack([X, Y, Z, one, zero, zero, zero, zero,
                      -u * X, -u * Y, -u * Z, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, zero, X, Y, Z, one,
                      -v * X, -v * Y, -v * Z, -v], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    p = smallmat.smallest_eigvec(A.transpose(-1, -2) @ A)
    Pn = p.unflatten(-1, (3, 4))
    # Denormalize: x ~ T2^-1 Pn T3 [X; 1] with T3 = [s3 I | -s3 c3; 0 1]
    # and T2^-1 = [I / s2 | c2; 0 1] on homogeneous 2-D points.
    z0 = torch.zeros_like(s2)
    o1 = torch.ones_like(s2)
    T2inv = torch.stack([
        torch.stack([1.0 / s2, z0, c2[..., 0]], -1),
        torch.stack([z0, 1.0 / s2, c2[..., 1]], -1),
        torch.stack([z0, z0, o1], -1)], -2)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    top = torch.cat([s3[..., None, None] * eye3,
                     (-s3[..., None] * c3)[..., :, None]], dim=-1)
    bottom = torch.cat([torch.zeros_like(top[..., :1, :3]),
                        torch.ones_like(top[..., :1, :1])], dim=-1)
    T3 = torch.cat([top, bottom], dim=-2)
    P = T2inv @ Pn @ T3
    # Scale: rotation rows must have unit norm; sign: cheirality on the
    # weighted centroid.
    scale = (smallmat.det3x3(P[..., :3]).abs() + 1e-20) ** (1.0 / 3.0)
    P = P / torch.where(scale < 1e-10, 1e-10, scale)[..., None, None]
    centroid = (pts * w[..., None]).sum(-2) / wsum[..., None]
    z = (P[..., 2, :3] * centroid).sum(-1) + P[..., 2, 3]
    P = P * torch.where(z < 0, -1.0, 1.0)[..., None, None]
    return se3.project_to_so3(P[..., :3]), P[..., 3]


def _gn_polish(pts, x, w, R, t, iters: int = 8):
    """Gauss-Newton on the weighted reprojection error in normalized
    coordinates over a left-multiplied se(3) increment: pts (..., N, 3),
    x (..., N, 2), w (..., N), R (..., 3, 3), t (..., 3)."""
    eye3 = torch.eye(3, dtype=pts.dtype, device=pts.device)
    eye6 = torch.eye(6, dtype=pts.dtype, device=pts.device)
    for _ in range(iters):
        pc = pts @ R.transpose(-1, -2) + t[..., None, :]
        z = torch.clamp_min(pc[..., 2], 1e-6)
        r = pc[..., :2] / z[..., None] - x
        inv_z = 1.0 / z
        zz = torch.zeros_like(z)
        J_pc = torch.stack([
            torch.stack([inv_z, zz, -pc[..., 0] * inv_z ** 2], -1),
            torch.stack([zz, inv_z, -pc[..., 1] * inv_z ** 2], -1)], -2)
        hat_pc = se3.hat(pc)
        J_xi = torch.cat([-hat_pc, eye3.expand(hat_pc.shape)], dim=-1)
        J = J_pc @ J_xi                                   # (..., N, 2, 6)
        Jw = J * w[..., None, None]
        H = torch.einsum('...nij,...nik->...jk', Jw, J) + 1e-8 * eye6
        g = torch.einsum('...nij,...ni->...j', Jw, r)
        dx = -smallmat.cholesky_solve(H, g)
        dR = se3.exp_so3(dx[..., :3])
        R, t = dR @ R, _mv(dR, t) + dx[..., 3:]
    return R, t


def _gather_rows(x, idx):
    """x (..., N, C), idx (..., H, k) -> (..., H, k, C)."""
    lead = idx.shape[:-2]
    flat = idx.reshape(*lead, -1).long()
    out = torch.gather(x, -2, flat[..., None].expand(*flat.shape,
                                                     x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def solve_pnp_ransac(K: torch.Tensor, pts_w: torch.Tensor, uv: torch.Tensor,
                     mask: torch.Tensor, gumbel: torch.Tensor,
                     threshold_px: float = 1.8, num_hypotheses: int = 512,
                     min_inliers: int = 10, polish_iters: int = 8,
                     scores: Optional[torch.Tensor] = None,
                     score_weight: float = 4.0) -> PnPResult:
    """RANSAC PnP over padded 3D-2D correspondences pts_w (..., N, 3),
    uv (..., N, 2) pixels, mask (..., N); `gumbel` (..., num_hypotheses, N).

    `scores` ((..., N) in [0, 1], optional): a match-confidence prior for
    the minimal samples. Gumbel-max with logits score_weight * log(score)
    draws each 6-point sample proportionally to score^score_weight; at the
    loop detector's 25-40 % inlier fraction, where uniform samples at 512
    hypotheses fail outright, true matches score systematically higher
    than aliased ones. Scoring and the refit use every masked point."""
    f32 = torch.float32
    pts_w = pts_w.to(f32)
    x = projection.normalize_points(K, uv.to(f32))
    f = 0.5 * (K[..., 0, 0] + K[..., 1, 1])
    thr = threshold_px / f
    thr2_s = thr * thr

    def thr2(like):
        """The squared threshold against `like` (one per stream)."""
        return projection.per_stream(thr2_s, K, like.dim())

    maskf = mask.to(f32)
    if gumbel.shape[-2] != num_hypotheses:
        raise ValueError(f"gumbel draws {tuple(gumbel.shape)} do not hold "
                         f"{num_hypotheses} hypotheses")

    g = gumbel.to(f32)
    if scores is not None:
        g = g + score_weight * torch.log(
            torch.clamp(scores.to(f32), 1e-6, 1.0))[..., None, :]
    g = torch.where(mask[..., None, :], g, -math.inf)
    _, sample_idx = topk_stable(g, 6)                     # (..., H, 6)
    spts = _gather_rows(pts_w, sample_idx)
    sx = _gather_rows(x, sample_idx)
    Rs, ts = _dlt_pnp(spts, sx, torch.ones_like(sx[..., 0]))

    def score(R, t):
        """R (..., h, 3, 3), t (..., h, 3) -> (cost (..., h),
        e2 (..., h, N))."""
        pc = pts_w[..., None, :, :] @ R.transpose(-1, -2) + t[..., None, :]
        z = pc[..., 2]
        pred = pc[..., :2] / torch.clamp_min(z, 1e-6)[..., None]
        e2 = ((pred - x[..., None, :, :]) ** 2).sum(-1)
        e2 = torch.where(z > 1e-6, e2, thr2(e2))
        e2 = torch.where(mask[..., None, :], e2, thr2(e2))
        return torch.minimum(e2, thr2(e2)).sum(-1), e2

    costs, _ = score(Rs, ts)
    best = torch.argmin(costs, dim=-1)                    # first minimum
    R = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3)
    t = torch.take_along_dim(ts, best[..., None, None], dim=-2)
    R, t = R[..., 0, :, :], t[..., 0, :]

    # iterative refit: GN polish on the inlier set, recompute the inliers
    for _ in range(polish_iters):
        _, e2 = score(R[..., None, :, :], t[..., None, :])
        w = maskf * (e2[..., 0, :] < thr2(maskf)).to(f32)
        w = torch.where(w.sum(-1, keepdim=True) >= 6, w, maskf)
        R, t = _gn_polish(pts_w, x, w, R, t, iters=2)

    _, e2 = score(R[..., None, :, :], t[..., None, :])
    inliers = mask & (e2[..., 0, :] < thr2(maskf))
    num_inliers = inliers.to(torch.int32).sum(-1, dtype=torch.int32)
    return PnPResult(R=R, t=t, inliers=inliers, num_inliers=num_inliers,
                     ok=num_inliers >= min_inliers)
