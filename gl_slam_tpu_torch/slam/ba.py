"""Sliding-window bundle adjustment: Schur-complement Levenberg-Marquardt.

Counterpart of gl_slam_tpu/slam/ba.py. The window is small (<= 16 cameras),
so the reduced camera system is a dense (6C x 6C) matrix and the solve is an
explicit Schur elimination with batched dense algebra:

  * the observation table is the fixed (C x N) grid of window keypoint slots
    (every keypoint row of every window keyframe); invalid slots carry zero
    weight, so extraction needs no compaction;
  * per-point 3x3 Hessian blocks invert in closed form;
  * the camera-point coupling W is built from each point's <= O observations
    with gathers and a one-hot over the camera axis, and S = Hcc - W Hpp^-1
    W^T is one (6C x 3P) x (3P x 6C) product;
  * everything runs in full float32 (TF32 off, ops/precision.py).

The LM loop: the JAX version is a `while_loop` that ends after
`full_ba_iters` iterations or two stalled ones. Here all `full_ba_iters`
iterations run and a `done` flag freezes the carry once two iterations have
stalled, which gives the same result as the early exit and needs no read
of the stall counter on the host: a BA pass issues its kernels without one
synchronisation.

Under a stream axis (slam/state.py) `first_kf` and `window` are (S,)
tensors and every stream solves its own window: the per-stream arrays
carry the axis in front, the LM's cost, damping and stall counters are
(S,), and a stream's carry freezes on its own two stalls while the others
run on (the select that `vmap` makes of JAX's early stop). The
observation grid's camera column `obs_cam` is the same for every stream
and has no stream axis.

Scatters: `_scatter` (slam/state.py) sends "nowhere" to one spare row. Where
indices repeat (window membership, the table-agreement flags) every writer
writes the same value, so the unordered CUDA `index_put_` is safe; the
write-backs of poses, points and culling flags have unique indices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SLAMConfig
from ..geometry import projection, se3
from ..ops import select as select_ops
from ..ops import smallmat
from .state import MapState, _at, _gather, _scatter, _where

_I32 = torch.int32


class WindowProblem(NamedTuple):
    cam_ids: torch.Tensor    # (C,) global keyframe ids (-1 pad)
    cam_mask: torch.Tensor   # (C,) in-window
    cam_free: torch.Tensor   # (C,) optimized (gauge: first two fixed)
    pt_ids: torch.Tensor     # (P,) global map-point ids (-1 pad)
    pt_mask: torch.Tensor    # (P,)
    # (P,) optimized: points created inside or shortly before the window
    # (pts_first_kf >= first_kf - ba.point_freeze_margin). Older points are
    # fixed anchors: their residuals constrain the window cameras but their
    # positions do not move.
    pt_free: torch.Tensor
    obs_cam: torch.Tensor    # (M,) local camera index (M = C*N grid)
    obs_pt: torch.Tensor     # (M,) local point index
    obs_uv: torch.Tensor     # (M,2)
    obs_mask: torch.Tensor   # (M,)
    # The same observations from the map's per-point observation table, so
    # that the point-side reductions are gathers instead of scatters.
    pt_obs_flat: torch.Tensor  # (P,O) index into the (M,) obs rows, 0 if pad
    pt_obs_cam: torch.Tensor   # (P,O) local camera id, -1 pad
    pt_obs_mask: torch.Tensor  # (P,O)


def _as_i32(x, device) -> torch.Tensor:
    """int32 tensor on `device` (a tensor keeps its shape: () or one entry
    per stream); a Python int becomes a () tensor by a fill (no
    host-to-device copy, which would make the host wait for the stream)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=_I32)
    return torch.full((), int(x), dtype=_I32, device=device)


def extract_window(cfg: SLAMConfig, mstate: MapState, first_kf,
                   window) -> WindowProblem:
    """Gather the fixed-shape window problem from the map state. `first_kf`
    and `window` are int32 tensors (() or (S,) under a stream axis) or
    ints: nothing is read back."""
    C = cfg.ba.max_window_cameras
    P = cfg.ba.max_window_points
    N = mstate.kf_kpts.shape[-2]
    Pmax = mstate.capacity_pts
    L = mstate.lead
    lead = mstate.num_kf.shape
    dev = mstate.kf_R.device
    first_kf = _as_i32(first_kf, dev)
    window = _as_i32(window, dev)

    local = torch.arange(C, dtype=_I32, device=dev)
    cam_ids = first_kf[..., None] + local
    cam_mask = (local < window[..., None]) \
        & (cam_ids < mstate.num_kf[..., None])
    cam_rows = torch.where(cam_mask, cam_ids, 0)
    # Gauge: hold the first window cameras constant
    cam_free = cam_mask & (local >= cfg.ba.gauge_fixed_cameras)

    # Window points: every map point referenced by a window keyframe slot.
    rows_mp = _gather(mstate.kf_kp2mp, cam_rows, L)            # (C,N)
    rows_mp = torch.where(cam_mask[..., None], rows_mp, -1)
    # Repeated indices all write True.
    member = _scatter(torch.zeros(lead + (Pmax,), dtype=torch.bool,
                                  device=dev),
                      torch.where(rows_mp >= 0, rows_mp, Pmax).reshape(
                          lead + (-1,)), True, lead=L)
    member = member & mstate.pts_valid & ~mstate.pts_bad
    pt_ids, pt_mask = select_ops.select_lowest_ids(member, P)
    ar_p = torch.arange(P, dtype=_I32, device=dev)
    # global -> local point index over Pmax + 1 slots; every padded row
    # writes -1 to the spare slot Pmax.
    g2l = _scatter(torch.full(lead + (Pmax + 1,), -1, dtype=_I32,
                              device=dev),
                   torch.where(pt_mask, pt_ids, Pmax),
                   torch.where(pt_mask, ar_p, -1), lead=L)

    # Observation grid: (C, N) keypoint slots flattened.
    obs_cam = torch.arange(C, dtype=_I32, device=dev).repeat_interleave(N)
    mp = rows_mp.reshape(lead + (-1,))
    lp = _gather(g2l, torch.where(mp >= 0, mp, Pmax), L)
    obs_uv = _gather(mstate.kf_kpts, cam_rows, L).reshape(lead + (-1, 2))
    obs_mask = (mp >= 0) & (lp >= 0) & cam_mask[..., obs_cam.long()] \
        & _gather(mstate.kf_kp_valid, cam_rows, L).reshape(lead + (-1,))

    # Per-point observation lists from the map's table; observations outside
    # the window are masked.
    ids_c = torch.clamp(pt_ids, 0, Pmax - 1)
    po_kf = _gather(mstate.pts_obs_kf, ids_c, L)                # (P,O)
    po_kp = _gather(mstate.pts_obs_kp, ids_c, L)
    po_local = po_kf - first_kf[..., None, None]
    po_ok = pt_mask[..., None] & (po_kf >= 0) \
        & (po_local >= 0) & (po_local < C) & (po_local < window[..., None,
                                                                 None])
    po_local_c = torch.clamp(po_local, 0, C - 1)
    pt_obs_flat = po_local_c * N + torch.clamp(po_kp, 0, N - 1)
    # The two views must agree (kp2mp may have been overwritten) ...
    po_ok = po_ok & (_gather(lp, pt_obs_flat, L) == ar_p[:, None]) \
        & _gather(obs_mask, pt_obs_flat, L)
    # ... in both directions: the grid may carry an observation the ring
    # table dropped. Repeated indices all write True.
    in_table = _scatter(
        torch.zeros(lead + (C * N,), dtype=torch.bool, device=dev),
        torch.where(po_ok, pt_obs_flat, C * N).reshape(lead + (-1,)), True,
        lead=L)
    obs_mask = obs_mask & in_table
    pt_free = pt_mask & (_gather(mstate.pts_first_kf, ids_c, L)
                         >= first_kf[..., None] - cfg.ba.point_freeze_margin)
    return WindowProblem(
        cam_ids=torch.where(cam_mask, cam_ids, -1), cam_mask=cam_mask,
        cam_free=cam_free, pt_ids=torch.where(pt_mask, pt_ids, -1),
        pt_mask=pt_mask, pt_free=pt_free, obs_cam=obs_cam,
        obs_pt=torch.clamp(lp, 0, P - 1), obs_uv=obs_uv, obs_mask=obs_mask,
        pt_obs_flat=torch.where(po_ok, pt_obs_flat, 0),
        pt_obs_cam=torch.where(po_ok, po_local_c, -1), pt_obs_mask=po_ok)


def _residual_jacobians(K, R_all, t_all, X_all, prob: WindowProblem):
    """Residuals + camera/point Jacobians for every observation slot
    (leading stream axes allowed in front of every array).

    Returns r (M,2), Jc (M,2,6), Jp (M,2,3), behind (M,)."""
    cam = prob.obs_cam.long()
    Ro = R_all[..., cam, :, :]                   # (M,3,3)
    Xo = _gather(X_all, prob.obs_pt, X_all.dim() - 2)
    pc = (Ro @ Xo[..., None])[..., 0] + t_all[..., cam, :]
    fx, fy, cx, cy = projection.intrinsics(K, pc[..., 0])
    z = torch.clamp_min(pc[..., 2], 1e-6)
    inv_z = 1.0 / z
    u = fx * pc[..., 0] * inv_z + cx
    v = fy * pc[..., 1] * inv_z + cy
    r = torch.stack([u, v], dim=-1) - prob.obs_uv
    zero = torch.zeros_like(z)
    J_pc = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * pc[..., 0] * inv_z ** 2], -1),
        torch.stack([zero, fy * inv_z, -fy * pc[..., 1] * inv_z ** 2], -1),
    ], dim=-2)                                   # (M,2,3)
    hat_pc = se3.hat(pc)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand_as(hat_pc)
    Jc = J_pc @ torch.cat([-hat_pc, eye], dim=-1)  # (M,2,6)
    Jp = J_pc @ Ro                               # (M,2,3)
    return r, Jc, Jp, pc[..., 2] <= 1e-6


def _robust_cost(r, behind, mask, cauchy_scale: float):
    c2 = cauchy_scale * cauchy_scale
    rho = c2 * torch.log1p((r * r).sum(-1) / c2)
    rho = torch.where(behind, c2 * 10.0, rho)
    return (mask * rho).sum(-1)


def _diag_part(H: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))


def solve_window(cfg: SLAMConfig, K, R0, t0, X0, prob: WindowProblem):
    """LM with dense Schur elimination over the window problem.

    R0/t0: (C,3,3)/(C,3) initial window poses; X0: (P,3) initial points
    (each with a stream axis in front under one). Returns (R, t, X,
    final_cost, final residuals (M,2), behind (M,), and the number of
    iterations taken before the carry froze, () int32)."""
    C, P = R0.shape[-3], X0.shape[-2]
    L = R0.dim() - 3
    lead = R0.shape[:L]
    dtype = torch.float32
    dev = R0.device
    b = cfg.ba
    cauchy = b.full_ba_cauchy_scale
    maskf = prob.obs_mask.to(dtype)
    free_cam = prob.cam_free.to(dtype)
    # Pre-window points are fixed anchors: their point-side Jacobians are
    # zeroed, so they add residuals to the camera system but never move.
    pt_freef = (prob.pt_mask & prob.pt_free).to(dtype)
    I6 = torch.eye(6, dtype=dtype, device=dev)
    I3 = torch.eye(3, dtype=dtype, device=dev)
    eyeC = torch.eye(C, dtype=dtype, device=dev)
    N = prob.obs_mask.shape[-1] // C
    onehot_cam = (prob.pt_obs_cam[..., None] == torch.arange(
        C, dtype=_I32, device=dev)).to(dtype)                  # (P,O,C)
    fo = prob.pt_obs_flat                                      # (P,O)
    po_maskf = prob.pt_obs_mask.to(dtype)
    free_cam_obs = free_cam[..., prob.obs_cam.long()][..., None, None]
    fixed = (1.0 - free_cam)[..., None, None]
    padp = (1.0 - pt_freef)[..., None, None]    # padded or fixed -> identity
    # (stream, P, C, 6, 3) -> (stream, C, 6, P, 3)
    to_rows = tuple(range(L)) + (L + 1, L + 2, L, L + 3)

    def step(R, t, X, lam):
        r, Jc, Jp, behind = _residual_jacobians(K, R, t, X, prob)
        w = projection.cauchy_weight((r * r).sum(-1), cauchy) * maskf
        w = torch.where(behind, 0.0, w)
        Jc = Jc * free_cam_obs                   # fixed cameras stay constant
        Jc_w = Jc * w[..., None, None]
        # Camera side: the obs set is the (C,N) grid, so the sum over a
        # camera's observations is a reshape and a sum.
        Hcc = torch.einsum('...mij,...mik->...mjk', Jc_w, Jc).reshape(
            lead + (C, N, 6, 6)).sum(-3)                        # (C,6,6)
        gc = torch.einsum('...mij,...mi->...mj', Jc_w, r).reshape(
            lead + (C, N, 6)).sum(-2)
        # Point side: gather each point's <= O observations from the grid.
        w_o = (_gather(w, fo, L) * po_maskf)[..., None, None]   # (P,O,1,1)
        Jp_o = _gather(Jp, fo, L) * pt_freef[..., None, None, None]
        Jc_o = _gather(Jc, fo, L)                               # (P,O,2,6)
        r_o = _gather(r, fo, L)                                 # (P,O,2)
        Jp_ow = Jp_o * w_o
        Hpp = torch.einsum('...poij,...poik->...pjk', Jp_ow, Jp_o)
        gp = torch.einsum('...poij,...poi->...pj', Jp_ow, r_o)  # (P,3)
        W = torch.einsum('...pojk,...poc->...pcjk', torch.einsum(
            '...poij,...poik->...pojk', Jc_o * w_o, Jp_o),
            onehot_cam)                                         # (P,C,6,3)

        lam3 = lam.reshape(lead + (1, 1, 1))
        Hcc_d = Hcc + lam3 * _diag_part(Hcc) + 1e-8 * I6
        # Fixed/padded cameras get identity blocks to keep S well posed
        Hcc_d = Hcc_d * (1.0 - fixed) + fixed * I6
        Hpp_d = Hpp + lam3 * _diag_part(Hpp) + 1e-8 * I3
        Hpp_d = Hpp_d * (1.0 - padp) + padp * I3
        Hpp_inv = smallmat.inv3x3(Hpp_d)                        # (P,3,3)

        # Schur complement S = Hcc - sum_p W_p Hpp^-1 W_p^T as one
        # (6C x 3P) x (3P x 6C) product, rows (c,i), columns (d,l).
        WHinv = torch.einsum('...pcij,...pjk->...pcik', W, Hpp_inv)
        A = WHinv.permute(to_rows).reshape(lead + (C * 6, P * 3))
        B = W.permute(to_rows).reshape(lead + (C * 6, P * 3))
        S = torch.einsum('cd,...cil->...cidl', eyeC, Hcc_d).reshape(
            lead + (C * 6, C * 6)) - A @ B.transpose(-1, -2)
        rhs = gc - torch.einsum('...pcik,...pk->...ci', WHinv, gp)
        dxc = -smallmat.scaled_solve(
            S, rhs.reshape(lead + (C * 6,))).reshape(lead + (C, 6))
        dxc = dxc * free_cam[..., None]
        # Back-substitute points
        rhs_p = gp + torch.einsum('...pcki,...ck->...pi', W, dxc)
        dxp = -torch.einsum('...pij,...pj->...pi', Hpp_inv, rhs_p) \
            * pt_freef[..., None]

        dR = se3.exp_so3(dxc[..., :3])
        R_new = dR @ R
        t_new = (dR @ t[..., None])[..., 0] + dxc[..., 3:]
        X_new = X + dxp
        r_new, _, _, behind_new = _residual_jacobians(K, R_new, t_new, X_new,
                                                      prob)
        return R_new, t_new, X_new, _robust_cost(r_new, behind_new, maskf,
                                                 cauchy)

    R, t, X = R0.to(dtype), t0.to(dtype), X0.to(dtype)
    r0, _, _, behind0 = _residual_jacobians(K, R, t, X, prob)
    cost = _robust_cost(r0, behind0, maskf, cauchy)
    lam = torch.full(lead, b.lm_lambda_init, dtype=dtype, device=dev)
    stall = torch.zeros(lead, dtype=_I32, device=dev)
    live_iters = torch.zeros(lead, dtype=_I32, device=dev)
    for _ in range(b.full_ba_iters):
        # Two stalled iterations end the solve: from then on the carry is
        # frozen (the reference's while_loop exits instead).
        done = stall >= 2
        live_iters = live_iters + (~done).to(_I32)
        R_new, t_new, X_new, new_cost = step(R, t, X, lam)
        accept = (new_cost < cost) & ~done
        improved = accept & (cost - new_cost > b.lm_rel_tol * cost)
        stall = torch.where(done, stall, torch.where(improved, 0, stall + 1))
        R = _where(accept, R_new, R)
        t = _where(accept, t_new, t)
        X = _where(accept, X_new, X)
        lam = torch.where(done, lam, torch.clamp(
            torch.where(accept, lam * b.lm_lambda_down, lam * b.lm_lambda_up),
            1e-9, 1e8))
        cost = torch.where(accept, new_cost, cost)
    # Final residuals for the caller (culling reuses them)
    r_fin, _, _, behind_fin = _residual_jacobians(K, R, t, X, prob)
    return R, t, X, cost, r_fin, behind_fin, live_iters


def cull_points(cfg: SLAMConfig, mstate: MapState, first_kf,
                prob: WindowProblem, r, behind) -> torch.Tensor:
    """Post-BA map-point culling: a point first seen in the window turns
    bad if it lies behind any observing camera, has fewer than
    `cull_min_obs` observations, or its mean reprojection error exceeds
    `cull_max_reproj_px`. Reuses the solver's final residuals (`r`, `behind`
    over the (C,N) grid). Returns the updated pts_bad."""
    L = mstate.lead
    Pmax = mstate.capacity_pts
    ids = torch.clamp(prob.pt_ids, 0, Pmax - 1)
    first_kf = _as_i32(first_kf, ids.device)
    in_window = prob.pt_mask & (_gather(mstate.pts_first_kf, ids, L)
                                >= first_kf[..., None])

    fo = prob.pt_obs_flat                                    # (P,O)
    ok = prob.pt_obs_mask
    err = _gather(torch.sqrt((r ** 2).sum(-1)), fo, L)       # (P,O)
    behind_any = (ok & _gather(behind, fo, L)).any(-1)
    n_obs = ok.to(_I32).sum(-1, dtype=_I32)
    mean_err = torch.where(ok, err, 0.0).sum(-1) / torch.clamp_min(n_obs, 1)
    # The obs<3 rule uses the true count (the table is a ring over the most
    # recent O observations; pts_obs_cnt keeps the total)
    true_obs = _gather(mstate.pts_obs_cnt, ids, L)
    bad = in_window & (behind_any | (true_obs < cfg.map.cull_min_obs)
                       | (mean_err > cfg.map.cull_max_reproj_px))
    # `.at[tgt].max(bad)`: window point ids are unique, so OR-ing into the
    # gathered flags and writing them back is the same update.
    tgt = torch.where(prob.pt_mask, prob.pt_ids, Pmax)
    return _scatter(mstate.pts_bad, tgt,
                    _gather(mstate.pts_bad, ids, L) | bad, lead=L)


def apply_rigid_delta(mstate: MapState, dR, dt, kf_from) -> MapState:
    """Post-BA consistency: apply the rigid delta (dR, dt) to every keyframe
    id >= kf_from and every map point created by one of those keyframes
    (pts_first_kf >= kf_from: creation keyframe, not slot id, because slot
    recycling reuses low ids for new points)."""
    Kmax = mstate.capacity_kf
    dev = mstate.kf_R.device
    kf_from = _as_i32(kf_from, dev)
    ar = torch.arange(Kmax, dtype=_I32, device=dev)
    kf_sel = (ar >= kf_from) & (ar < mstate.num_kf)
    # The delta acts on world->camera poses as T_new = T_old o dT^{-1}.
    dRi, dti = se3.inverse(dR, dt)
    R_new = mstate.kf_R @ dRi
    t_new = (mstate.kf_R @ dti[:, None])[..., 0] + mstate.kf_t
    kf_R = torch.where(kf_sel[:, None, None], R_new, mstate.kf_R)
    kf_t = torch.where(kf_sel[:, None], t_new, mstate.kf_t)

    pt_sel = (mstate.pts_first_kf >= kf_from) & mstate.pts_valid
    X_new = mstate.pts_xyz @ dR.T + dt
    pts_xyz = torch.where(pt_sel[:, None], X_new, mstate.pts_xyz)
    return mstate._replace(kf_R=kf_R, kf_t=kf_t, pts_xyz=pts_xyz)


def reconcile_async_ba(live: MapState, ba: MapState, kf_from,
                       pt_from) -> MapState:
    """Merge a BA result computed on a snapshot into the live map.

    Entities that existed at snapshot time take the BA-optimized values;
    entities created meanwhile keep their live values, realigned by the
    SO(3)-projected delta of the anchor (last snapshot) keyframe; culling
    flags merge by OR, except on slots the live map recycled meanwhile,
    whose BA-side flags describe the previous occupant. kf_from/pt_from: the
    snapshot's num_kf / num_pts."""
    Kmax = live.capacity_kf
    dev = live.kf_R.device
    kf_from = _as_i32(kf_from, dev)
    pt_from = _as_i32(pt_from, dev)
    anchor = torch.clamp(kf_from - 1, 0, Kmax - 1).long()
    dR, dt = se3.delta_pose(_at(live.kf_R, anchor), _at(live.kf_t, anchor),
                            _at(ba.kf_R, anchor), _at(ba.kf_t, anchor))
    kf_old = torch.arange(Kmax, dtype=_I32, device=dev) < kf_from
    created_live = live.pts_first_kf >= kf_from
    pt_old = (torch.arange(live.capacity_pts, dtype=_I32, device=dev)
              < pt_from) & ~created_live
    merged = live._replace(
        kf_R=torch.where(kf_old[:, None, None], ba.kf_R, live.kf_R),
        kf_t=torch.where(kf_old[:, None], ba.kf_t, live.kf_t),
        pts_xyz=torch.where(pt_old[:, None], ba.pts_xyz, live.pts_xyz),
        pts_bad=torch.where(created_live, live.pts_bad,
                            live.pts_bad | ba.pts_bad))
    return apply_rigid_delta(merged, dR, dt, kf_from)


def window_reprojection(K, mstate: MapState, prob: WindowProblem):
    """Mean reprojection error (px, () tensor, or (S,) under a stream
    axis) of the map over the window problem's observations that lie in
    front of their cameras."""
    L = mstate.lead
    cam_idx = torch.clamp(prob.cam_ids, 0, mstate.capacity_kf - 1)
    pt_idx = torch.clamp(prob.pt_ids, 0, mstate.capacity_pts - 1)
    r, _, _, behind = _residual_jacobians(
        K, _gather(mstate.kf_R, cam_idx, L), _gather(mstate.kf_t, cam_idx, L),
        _gather(mstate.pts_xyz, pt_idx, L), prob)
    msk = prob.obs_mask & ~behind
    err = torch.sqrt((r * r).sum(-1))
    return torch.where(msk, err, 0.0).sum(-1) \
        / torch.clamp_min(msk.sum(-1), 1)


class BADiag(NamedTuple):
    """Diagnostics of one BA pass, () device tensors (nothing is read)."""
    reproj_before: torch.Tensor  # mean window reprojection error (px)
    reproj_after: torch.Tensor
    lm_iters: torch.Tensor       # LM iterations before the carry froze


def ba_step(cfg: SLAMConfig, K, mstate: MapState, first_kf,
            window) -> MapState:
    """One sliding-window BA pass: extract -> solve -> write back -> cull."""
    return _ba_step(cfg, K, mstate, first_kf, window, False)[0]


def ba_step_diag(cfg: SLAMConfig, K, mstate: MapState, first_kf, window):
    """`ba_step` -> (MapState, BADiag): also the window's mean reprojection
    error before and after the pass, over the pass's own window problem, and
    the LM's live iteration count."""
    return _ba_step(cfg, K, mstate, first_kf, window, True)


def _ba_step(cfg, K, mstate, first_kf, window, want_diag):
    prob = extract_window(cfg, mstate, first_kf, window)
    before = window_reprojection(K, mstate, prob) if want_diag else None
    Kmax = mstate.capacity_kf
    Pmax = mstate.capacity_pts
    L = mstate.lead

    cam_idx = torch.clamp(prob.cam_ids, 0, Kmax - 1)
    R0 = _gather(mstate.kf_R, cam_idx, L)
    t0 = _gather(mstate.kf_t, cam_idx, L)
    X0 = _gather(mstate.pts_xyz, torch.clamp(prob.pt_ids, 0, Pmax - 1), L)
    R, t, X, _, r_fin, behind_fin, lm_iters = solve_window(
        cfg, K, R0, t0, X0, prob)

    # Re-orthonormalize before write-back: the solved poses are chains of
    # f32 exp-map products.
    R = se3.project_to_so3(R)
    # Unique indices (window camera and point ids), the rest to the spare row
    kf_tgt = torch.where(prob.cam_mask & prob.cam_free, prob.cam_ids, Kmax)
    kf_R = _scatter(mstate.kf_R, kf_tgt, R, lead=L)
    kf_t = _scatter(mstate.kf_t, kf_tgt, t, lead=L)
    pt_tgt = torch.where(prob.pt_mask, prob.pt_ids, Pmax)
    pts_xyz = _scatter(mstate.pts_xyz, pt_tgt, X, lead=L)
    mstate = mstate._replace(kf_R=kf_R, kf_t=kf_t, pts_xyz=pts_xyz)

    if cfg.map.cull_enabled:
        mstate = mstate._replace(pts_bad=cull_points(
            cfg, mstate, first_kf, prob, r_fin, behind_fin))
    if not want_diag:
        return mstate, None
    return mstate, BADiag(before, window_reprojection(K, mstate, prob),
                          lm_iters)
