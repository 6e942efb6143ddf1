"""Window bundle adjustment, written from its definition in plain PyTorch.

The problem is the one the configuration states for a pass over a
stream's last `window` keyframes:
  * cameras: the window's keyframes (at most `max_window_cameras`), the
    first `gauge_fixed_cameras` held;
  * points: every live map point (valid, not culled) that a keypoint of a
    window keyframe names, the lowest `max_window_points` ids; a point
    created more than `point_freeze_margin` keyframes before the window
    is held;
  * observations: each valid keypoint of a window keyframe that names a
    window point whose observation table lists that keyframe and keypoint;
  * cost: the sum over observations of the Cauchy loss of the pixel
    reprojection error, c^2 log(1 + |r|^2 / c^2), and 10 c^2 for a point
    at or behind its camera's plane (depth <= 1e-6).

`solve` minimises it by Levenberg-Marquardt with the points eliminated
(Schur complement) until the cost stops falling, in float64. With
`tf32=True` it runs in float32 with both operands of every product
rounded to TF32's 10-bit mantissa, as a matmul with TF32 on computes it:
the control, one precision below the configuration's float32 BA. `cost`
judges any state of the problem in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BEHIND_Z = 1e-6
MAX_ITERS = 100
REL_TOL = 1e-10


class Problem(NamedTuple):
    first: int               # global id of the window's first keyframe
    cam: torch.Tensor        # (n,) local camera of each observation
    pt: torch.Tensor         # (n,) local point of each observation
    uv: torch.Tensor         # (n, 2) observed keypoint (px), float64
    cam_free: torch.Tensor   # (C,) bool
    pt_free: torch.Tensor    # (P,) bool
    pt_ids: np.ndarray       # (P,) global point ids
    K: tuple                 # fx, fy, cx, cy
    cauchy: float


def window_problem(m: dict, spec: dict, K: np.ndarray, device) -> Problem:
    """The pass's problem from one stream's map arrays `m` (numpy; the
    MapState fields named in `harness.PRE_BA`) before the pass. `spec`:
    window, max_window_cameras, max_window_points, gauge_fixed_cameras,
    point_freeze_margin, cauchy."""
    nk = int(m["num_kf"])
    first = max(nk - spec["window"], 0)
    C = min(nk - first, spec["max_window_cameras"])
    rows = np.arange(first, first + C)
    kp2mp = m["kf_kp2mp"][rows]                               # (C, N)
    live = m["pts_valid"] & ~m["pts_bad"]
    named = np.unique(kp2mp[kp2mp >= 0])
    pt_ids = named[live[named]][:spec["max_window_points"]]
    local = np.full(len(live), -1, np.int64)
    local[pt_ids] = np.arange(len(pt_ids))
    c, n = np.nonzero(kp2mp >= 0)
    gid = kp2mp[c, n]
    p = local[gid]
    ok = (p >= 0) & m["kf_kp_valid"][rows][c, n]
    table = (m["pts_obs_kf"][gid] == (first + c)[:, None]) \
        & (m["pts_obs_kp"][gid] == n[:, None])
    ok &= table.any(1)
    c, n, p = c[ok], n[ok], p[ok]
    seen_c = np.bincount(c, minlength=C) > 0
    seen_p = np.bincount(p, minlength=len(pt_ids)) > 0
    cam_free = (np.arange(C) >= spec["gauge_fixed_cameras"]) & seen_c
    pt_free = (m["pts_first_kf"][pt_ids]
               >= first - spec["point_freeze_margin"]) & seen_p
    dev = torch.device(device)
    K = np.asarray(K, np.float64)
    return Problem(
        first=first,
        cam=torch.as_tensor(c, device=dev),
        pt=torch.as_tensor(p, device=dev),
        uv=torch.as_tensor(m["kf_kpts"][rows][c, n].astype(np.float64),
                           device=dev),
        cam_free=torch.as_tensor(cam_free, device=dev),
        pt_free=torch.as_tensor(pt_free, device=dev),
        pt_ids=pt_ids, K=(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
        cauchy=float(spec["cauchy"]))


def state_of(prob: Problem, m: dict, device):
    """(R (C,3,3), t (C,3), X (P,3)) of the problem's cameras and points
    in the map arrays `m`, in float64."""
    C = len(prob.cam_free)
    rows = np.arange(prob.first, prob.first + C)
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float64),  # noqa: E731
                                     device=device)
    return (as_t(m["kf_R"][rows]), as_t(m["kf_t"][rows]),
            as_t(m["pts_xyz"][prob.pt_ids]))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits, nearest)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _Prec:
    def __init__(self, tf32_on: bool):
        self.dtype = torch.float32 if tf32_on else torch.float64
        self.r = tf32 if tf32_on else (lambda x: x)

    def ein(self, eq, *xs):
        return torch.einsum(eq, *(self.r(x) for x in xs))


def _hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _exp_so3(w):
    th = torch.linalg.norm(w, dim=-1)[..., None, None]
    W = _hat(w)
    small = th < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, torch.ones_like(th), torch.sin(ths) / ths)
    b = torch.where(small, 0.5 * torch.ones_like(th),
                    (1 - torch.cos(ths)) / ths ** 2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * W + b * (W @ W)


def _residuals(prob, R, t, X, pr):
    """r (n,2), depth (n,), and the point in camera coordinates (n,3)."""
    fx, fy, cx, cy = prob.K
    Ro = R[prob.cam]
    pc = pr.ein("nij,nj->ni", Ro, X[prob.pt]) + t[prob.cam]
    z = pc[:, 2]
    zc = z.clamp_min(BEHIND_Z)
    uv = torch.stack([fx * pc[:, 0] / zc + cx, fy * pc[:, 1] / zc + cy], -1)
    return uv - prob.uv.to(uv.dtype), z, pc, Ro


def _robust(r, z, c):
    c2 = c * c
    rho = c2 * torch.log1p((r * r).sum(-1) / c2)
    return torch.where(z <= BEHIND_Z, torch.full_like(rho, 10.0 * c2), rho)


def cost(prob: Problem, R, t, X) -> float:
    """The problem's robust cost at (R, t, X), in float64."""
    f = torch.float64
    r, z, _, _ = _residuals(prob, R.to(f), t.to(f), X.to(f), _Prec(False))
    return float(_robust(r, z, prob.cauchy).sum())


def solve(prob: Problem, R, t, X, tf32_on: bool = False):
    """Levenberg-Marquardt from (R, t, X) until three accepted steps in a
    row lower the cost by no more than REL_TOL of it, the damping runs
    away or MAX_ITERS pass. Returns (R, t, X, iterations)."""
    pr = _Prec(tf32_on)
    dt = pr.dtype
    R, t, X = R.to(dt), t.to(dt), X.to(dt)
    C, P = R.shape[0], X.shape[0]
    dev = R.device
    fx, fy = prob.K[0], prob.K[1]
    cam_f = prob.cam_free.to(dt)
    pt_f = prob.pt_free.to(dt)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    pair = prob.pt * C + prob.cam

    def total(R, t, X):
        r, z, _, _ = _residuals(prob, R, t, X, pr)
        return _robust(r, z, prob.cauchy).sum()

    def step(R, t, X, lam):
        r, z, pc, Ro = _residuals(prob, R, t, X, pr)
        zc = z.clamp_min(BEHIND_Z)
        w = torch.where(z <= BEHIND_Z, torch.zeros_like(z),
                        1.0 / (1.0 + (r * r).sum(-1) / prob.cauchy ** 2))
        zero = torch.zeros_like(zc)
        J_pc = torch.stack([
            torch.stack([fx / zc, zero, -fx * pc[:, 0] / zc ** 2], -1),
            torch.stack([zero, fy / zc, -fy * pc[:, 1] / zc ** 2], -1)], -2)
        lie = torch.cat([-_hat(pc), eye3.expand(len(pc), 3, 3)], -1)
        Jc = pr.ein("nij,njk->nik", J_pc, lie) * cam_f[prob.cam][:, None,
                                                                 None]
        Jp = pr.ein("nij,njk->nik", J_pc, Ro) * pt_f[prob.pt][:, None, None]
        Jcw = Jc * w[:, None, None]
        Jpw = Jp * w[:, None, None]
        Hcc = torch.zeros(C, 6, 6, dtype=dt, device=dev).index_add_(
            0, prob.cam, pr.ein("nij,nik->njk", Jcw, Jc))
        gc = torch.zeros(C, 6, dtype=dt, device=dev).index_add_(
            0, prob.cam, pr.ein("nij,ni->nj", Jcw, r))
        Hpp = torch.zeros(P, 3, 3, dtype=dt, device=dev).index_add_(
            0, prob.pt, pr.ein("nij,nik->njk", Jpw, Jp))
        gp = torch.zeros(P, 3, dtype=dt, device=dev).index_add_(
            0, prob.pt, pr.ein("nij,ni->nj", Jpw, r))
        W = torch.zeros(P * C, 6, 3, dtype=dt, device=dev).index_add_(
            0, pair, pr.ein("nij,nik->njk", Jcw, Jp)).view(P, C, 6, 3)
        diag = lambda H: torch.diag_embed(  # noqa: E731
            torch.diagonal(H, dim1=-2, dim2=-1))
        hold_c = (1.0 - cam_f)[:, None, None]
        hold_p = (1.0 - pt_f)[:, None, None]
        Hcc = (Hcc + lam * diag(Hcc) + 1e-8 * eye6) * (1.0 - hold_c) \
            + hold_c * eye6
        Hpp = (Hpp + lam * diag(Hpp) + 1e-8 * eye3) * (1.0 - hold_p) \
            + hold_p * eye3
        Hinv = torch.linalg.inv(pr.r(Hpp))
        WH = pr.ein("pcij,pjk->pcik", W, Hinv)
        S = torch.block_diag(*Hcc).view(C, 6, C, 6) \
            - pr.ein("pcik,pdjk->cidj", WH, W)
        rhs = gc - pr.ein("pcik,pk->ci", WH, gp)
        dxc = -torch.linalg.solve(pr.r(S.reshape(6 * C, 6 * C)),
                                  pr.r(rhs.reshape(6 * C))).view(C, 6)
        dxc = dxc * cam_f[:, None]
        dxp = -pr.ein("pij,pj->pi", Hinv,
                      gp + pr.ein("pcki,ck->pi", W, dxc)) * pt_f[:, None]
        dR = _exp_so3(dxc[:, :3])
        return (pr.ein("cij,cjk->cik", dR, R),
                pr.ein("cij,cj->ci", dR, t) + dxc[:, 3:], X + dxp)

    f = total(R, t, X)
    lam, small, it = 1e-4, 0, 0
    while it < MAX_ITERS and small < 3 and lam < 1e12:
        it += 1
        Rn, tn, Xn = step(R, t, X, lam)
        fn = total(Rn, tn, Xn)
        if bool(fn < f):
            small = small + 1 if float(f - fn) <= REL_TOL * float(f) else 0
            R, t, X, f = Rn, tn, Xn, fn
            lam = max(lam * 0.1, 1e-12)
        else:
            lam *= 10.0
    return R, t, X, it
