"""Pose-only bundle adjustment: robust 6-DoF Levenberg-Marquardt.

Counterpart of gl_slam_tpu/slam/pose_ba.py. Points are held fixed and the
pose is refined against Cauchy-weighted pixel residuals through the 6x6
normal equations. The JAX version stops a start early (two iterations
without relative improvement) by freezing it; under `vmap` a frozen lane
simply keeps its carry while the loop runs on. This port runs the full
iteration budget with the same frozen-lane select, which gives the same
result as the early exit without reading anything back to the host.

On the card the whole solve is one launch of the hand-written kernel in
csrc/pose_lm.cu (all iterations of every start, both phases; the kernel's
note says why): `pose_only_ba_multi` takes the plain version only for CPU
tensors, and a CUDA tensor launches the kernel or raises. `pose_lm_layout`
lays the arguments out for it, `pose_lm_cuda` launches it, and
`pose_only_ba_multi_plain` is the plain version at any device (the CPU path,
and the card's yardstick).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..geometry import projection, se3
from ..ops import _build, smallmat


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


def pose_only_ba_multi_plain(K, R0s, t0s, pts_w, uv, mask, iters: int = 30,
                             cauchy_scale: float = 1.0,
                             lm_lambda_init: float = 1e-4,
                             coarse_iters: int = 0,
                             coarse_scale_mult: float = 8.0,
                             point_weights: Optional[torch.Tensor] = None
                             ) -> PoseBAResult:
    """`pose_only_ba_multi` in plain PyTorch, on any device."""
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


class LMLayout(NamedTuple):
    """The kernel's arguments: P = B x per problems, problem p at starts
    row p of R (P, 3, 3), t (P, 3), against point row p // per of pts
    (B, N, 3), uv (B, N, 2), mask (B, N) bool and pw (B, N) (or None),
    through K row p // per of K (B, 3, 3), or K (1, 3, 3) for all; `lead`
    is the starts' leading shape, that of the results."""
    K: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    pts: torch.Tensor
    uv: torch.Tensor
    mask: torch.Tensor
    pw: Optional[torch.Tensor]
    lead: tuple
    per: int


def pose_lm_layout(K, R0s, t0s, pts_w, uv, mask,
                   point_weights: Optional[torch.Tensor] = None) -> LMLayout:
    """Flatten the arguments of `pose_only_ba_multi` for the kernel: the
    starts' leading axes into one problem axis, the points' into one row
    axis. The points' leading shape has to be a prefix of the starts' (the
    axes behind it, a start axis, share a row); K is (3, 3) or carries the
    points' leading shape. Floats become contiguous float32, as the plain
    version computes in float32; anything else raises ValueError."""
    dt = torch.float32
    lead = tuple(R0s.shape[:-2])
    plead = tuple(pts_w.shape[:-2])
    N = pts_w.shape[-2] if pts_w.dim() >= 2 else -1
    if (R0s.shape[-2:] != (3, 3) or tuple(t0s.shape) != lead + (3,)
            or pts_w.shape[-1:] != (3,) or lead[:len(plead)] != plead):
        raise ValueError(f"pose_lm: bad shapes R0s {tuple(R0s.shape)} t0s "
                         f"{tuple(t0s.shape)} pts_w {tuple(pts_w.shape)}")
    if (tuple(uv.shape) != plead + (N, 2)
            or tuple(mask.shape) != plead + (N,)
            or (point_weights is not None
                and tuple(point_weights.shape) != plead + (N,))):
        raise ValueError(f"pose_lm: uv {tuple(uv.shape)}, mask "
                         f"{tuple(mask.shape)} or point_weights do not "
                         f"match pts_w {tuple(pts_w.shape)}")
    if tuple(K.shape) not in ((3, 3), plead + (3, 3)):
        raise ValueError(f"pose_lm: K {tuple(K.shape)} is neither (3, 3) "
                         f"nor per point row {plead + (3, 3)}")
    if mask.dtype != torch.bool:
        raise ValueError(f"pose_lm: mask must be bool, got {mask.dtype}")
    tensors = [K, R0s, t0s, pts_w, uv, mask] + (
        [] if point_weights is None else [point_weights])
    if len({x.device for x in tensors}) != 1:
        raise ValueError("pose_lm: the arguments lie on different devices")
    B = math.prod(plead)
    per = math.prod(lead[len(plead):])

    def flat(x, shape):
        return x.to(dt).reshape(shape).contiguous()

    return LMLayout(
        K=flat(K, (-1, 3, 3)), R=flat(R0s, (B * per, 3, 3)),
        t=flat(t0s, (B * per, 3)), pts=flat(pts_w, (B, N, 3)),
        uv=flat(uv, (B, N, 2)), mask=mask.reshape(B, N).contiguous(),
        pw=None if point_weights is None else flat(point_weights, (B, N)),
        lead=lead, per=per)


def pose_lm_cuda(K, R0s, t0s, pts_w, uv, mask, iters: int = 30,
                 cauchy_scale: float = 1.0, lm_lambda_init: float = 1e-4,
                 coarse_iters: int = 0, coarse_scale_mult: float = 8.0,
                 point_weights: Optional[torch.Tensor] = None,
                 live_iters: bool = False):
    """`pose_only_ba_multi` as one launch of csrc/pose_lm.cu. Returns
    (PoseBAResult, live) where `live` (with `live_iters`; else None) is
    each problem's count of iterations run, both phases, int32 shaped as
    the starts' leading axes: how much of the budget a start used before
    it stopped (tests and chip_smoke.py read it; the tracker does not)."""
    a = pose_lm_layout(K, R0s, t0s, pts_w, uv, mask, point_weights)
    if not a.R.is_cuda:
        raise ValueError("pose_lm_cuda: the arguments must be CUDA tensors")
    if not all(x.dtype == torch.float32 and x.is_contiguous() for x in
               (a.K, a.R, a.t, a.pts, a.uv) + (() if a.pw is None
                                                else (a.pw,))):
        raise ValueError("pose_lm_cuda: float arguments must be contiguous "
                         "float32")
    if iters < 0 or coarse_iters < 0:
        raise ValueError("pose_lm_cuda: negative iteration count")
    P, N = a.R.shape[0], a.pts.shape[1]
    if a.pts.numel() >= 2 ** 31 or P >= 2 ** 31:
        raise ValueError("pose_lm_cuda: 2^31 points or problems or more")
    dev = a.R.device
    R = torch.empty((P, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((P, 3), dtype=torch.float32, device=dev)
    cost = torch.empty((P,), dtype=torch.float32, device=dev)
    used = torch.empty((P,), dtype=torch.int32, device=dev)
    live = torch.empty((P,), dtype=torch.int32, device=dev) \
        if live_iters else None
    if P > 0:
        # the plain version's constants: Python floats, rounded to float32
        # where they meet a float32 tensor
        s_coarse = cauchy_scale * coarse_scale_mult
        c_coarse, c_fine = s_coarse * s_coarse, cauchy_scale * cauchy_scale
        ct = _build.ctypes
        fn = _build.load("pose_lm").gl_pose_lm
        fn.restype = ct.c_int
        fn.argtypes = [ct.c_void_p, ct.c_int] + [ct.c_void_p] * 6 \
            + [ct.c_int] * 4 + [ct.c_float] * 2 + [ct.c_int] \
            + [ct.c_float] * 3 + [ct.c_void_p] * 6
        err = fn(_build.ptr(a.K), a.K.shape[0], _build.ptr(a.R),
                 _build.ptr(a.t), _build.ptr(a.pts), _build.ptr(a.uv),
                 _build.ptr(a.mask.view(torch.uint8)),
                 None if a.pw is None else _build.ptr(a.pw), P, a.per, N,
                 int(coarse_iters), c_coarse, c_coarse * 10.0, int(iters),
                 c_fine, c_fine * 10.0, float(lm_lambda_init),
                 _build.ptr(R), _build.ptr(t), _build.ptr(cost),
                 _build.ptr(used), None if live is None else _build.ptr(live),
                 _build.stream_of(a.R))
        _build.LAUNCHES["pose_lm"] += 1
        _build.check(err, "pose_lm")
    res = PoseBAResult(R=R.view(a.lead + (3, 3)), t=t.view(a.lead + (3,)),
                       final_cost=cost.view(a.lead),
                       num_used=used.view(a.lead))
    return res, None if live is None else live.view(a.lead)


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
    are (S, 3, 3) or, with a start axis behind it, (S, starts, 3, 3).

    CUDA tensors launch the kernel (`pose_lm_cuda`), CPU tensors take the
    plain version."""
    kw = dict(iters=iters, cauchy_scale=cauchy_scale,
              lm_lambda_init=lm_lambda_init, coarse_iters=coarse_iters,
              coarse_scale_mult=coarse_scale_mult,
              point_weights=point_weights)
    if pts_w.is_cuda:
        return pose_lm_cuda(K, R0s, t0s, pts_w, uv, mask, **kw)[0]
    return pose_only_ba_multi_plain(K, R0s, t0s, pts_w, uv, mask, **kw)


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
