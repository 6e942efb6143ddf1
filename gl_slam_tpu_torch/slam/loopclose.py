"""Loop closing: detection, pose-graph optimisation, map correction.

Counterpart of gl_slam_tpu/slam/loopclose.py:

  * detection, keyframe-database path (`detect_loop_db`, the one the
    chunked driver runs): old keyframes near the current pose estimate are
    retrieved by a masked top-k over the keyframe table, each of the top
    `loop_candidates` matches its stored feature database against the
    current frame through the learned matcher (one batched call over the
    candidates), and PnP RANSAC against the stored 3-D snapshots verifies
    the candidate;
  * detection, map-archive path (`detect_loop` without a matcher): mutual
    nearest neighbours against a strided sample of old map points, a
    region vote over the observing keyframes, PnP per top region;
  * pose graph (`optimize_pose_graph`): sequential odometry edges plus the
    loop edge, dense Gauss-Newton over left se(3) increments;
  * correction (`apply_pose_graph_correction`): each map point moves
    rigidly with the keyframe that created it, each keyframe's database
    snapshot with its keyframe;
  * `close_loop`: the host-orchestrated closure that ties them together.

The matcher runs at the model's dtype (bf16 on the card), as in tracking;
everything else runs in full f32 (TF32 off on the card, ops/precision.py).
Detection reads nothing back to the host: its verdict stays on the device
until the caller reads it. `close_loop` reads the keyframe count and the
detection, as in JAX. Randomness is an argument: `gumbel` holds each
candidate's (or region's) PnP draws, shape (Q, hypotheses, N).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import SLAMConfig
from ..geometry import pnp, se3
from ..ops import match as match_ops
from ..ops import optim
from ..ops.select import topk_stable
from .state import MapState, _at, _scatter

_I32 = torch.int32


class LoopDetection(NamedTuple):
    ok: torch.Tensor           # () bool
    loop_kf: torch.Tensor      # () int32, the revisited keyframe
    R: torch.Tensor            # absolute pose of the current frame
    t: torch.Tensor
    num_inliers: torch.Tensor
    # Keyframe count at detection time: a lagged consumer (the chunked
    # driver reads `ok` one check interval later) attaches the loop edge to
    # the keyframe that was current when the detection ran.
    cur_kf: Optional[torch.Tensor] = None
    # Per-gate debug counters (None where a path does not compute them)
    n_vis: Optional[torch.Tensor] = None         # retrieved keyframes
    n_good: Optional[torch.Tensor] = None        # matcher hits > threshold
    region_votes: Optional[torch.Tensor] = None  # live candidates
    n_cons: Optional[torch.Tensor] = None        # consistent hits
    pnp_raw_ok: Optional[torch.Tensor] = None    # the PnP gate alone


def pnp_draws(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(u)), u uniform on [tiny, 1), as
    `jax.random.gumbel`."""
    u = torch.rand(shape, generator=gen, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def detect_loop_db(cfg: SLAMConfig, K, mstate: MapState, f, gumbel,
                   min_gap: int, min_inliers: int, matcher: Callable,
                   R_cur, t_cur) -> LoopDetection:
    """Keyframe-database loop detection.

    1. Retrieval: old keyframes (index < cur_kf - min_gap) whose camera
       centre lies within `loop_detect_radius` m of the current estimate
       and whose viewing direction agrees within
       `loop_detect_max_angle_deg`; the top `loop_candidates` by distance
       (ineligible keyframes score -inf; ties go to the lower index).
    2. Matching: each candidate's stored database (`kf_db_*`: keypoints
       with 3-D, snapshotted at insertion) against the current frame, one
       matcher call over the candidate axis. A candidate that does not
       exist still runs, on a clipped (possibly empty) keyframe.
    3. Verification: PnP RANSAC against the candidate's 3-D snapshots; the
       candidate with the most inliers wins, gated on `min_inliers` and
       `loop_min_votes` matcher hits.

    `f`: the current frame's FrameFeatures; `matcher(kpts0, desc0, valid0,
    kpts1, desc1, valid1) -> MatchResult` with a leading candidate axis;
    `gumbel` (loop_candidates, pnp_hypotheses, loop_db_keypoints)."""
    Kmax = mstate.capacity_kf
    Nk = mstate.kf_kpts.shape[1]
    dev = mstate.kf_R.device
    cur_kf = mstate.num_kf
    rt = cfg.runtime
    Q = rt.loop_candidates

    # 1. retrieval by pose proximity
    c_cur = -(R_cur.T @ t_cur)
    kf_c = -torch.einsum('kji,kj->ki', mstate.kf_R, mstate.kf_t)
    d2 = ((kf_c - c_cur) ** 2).sum(1)
    fwd_dot = mstate.kf_R[:, 2, :] @ R_cur[2]
    elig = ((torch.arange(Kmax, device=dev) < cur_kf - min_gap)
            & (mstate.kf_frame_idx >= 0)
            & (fwd_dot > math.cos(math.radians(rt.loop_detect_max_angle_deg)))
            & (d2 < rt.loop_detect_radius ** 2))
    score = torch.where(elig, -d2, -math.inf)
    svals, cands = topk_stable(score, Q)

    # 2 + 3. frame-pair match + PnP per candidate, batched over Q
    cc = torch.clamp(cands, 0, Kmax - 1)
    rows = torch.clamp(mstate.kf_db_idx[cc], 0, Nk - 1).long()   # (Q, Kdb)
    uv0 = torch.gather(mstate.kf_kpts[cc], 1,
                       rows[..., None].expand(*rows.shape, 2))
    desc0 = mstate.kf_db_desc[cc].to(f.desc.dtype)
    v0 = mstate.kf_db_valid[cc]
    N = f.kpts.shape[0]
    m = matcher(uv0, desc0, v0, f.kpts.expand(Q, *f.kpts.shape),
                f.desc.expand(Q, *f.desc.shape), f.valid.expand(Q, N))
    good = v0 & match_ops.score_filter(m.matches0, m.mscores0,
                                       cfg.frontend.map_match_threshold)
    uv_cur = f.kpts[torch.clamp(m.matches0, 0, N - 1).long()]
    res = pnp.solve_pnp_ransac(
        K, mstate.kf_db_xyz[cc], uv_cur, good, gumbel,
        threshold_px=cfg.geometry.pnp_threshold_px,
        num_hypotheses=cfg.geometry.pnp_hypotheses,
        min_inliers=min_inliers, scores=m.mscores0)
    n_good = good.to(_I32).sum(-1, dtype=_I32)
    cand_ok = torch.isfinite(svals)
    ok_q = cand_ok & res.ok & (n_good >= rt.loop_min_votes)
    best = torch.argmax(torch.where(ok_q, res.num_inliers, -1))
    return LoopDetection(
        ok=_at(ok_q, best), loop_kf=_at(cands, best).to(_I32),
        R=_at(res.R, best), t=_at(res.t, best),
        num_inliers=_at(res.num_inliers, best), cur_kf=cur_kf,
        n_vis=elig.to(_I32).sum(dtype=_I32), n_good=_at(n_good, best),
        region_votes=cand_ok.to(_I32).sum(dtype=_I32),
        n_cons=_at(n_good, best), pnp_raw_ok=_at(res.ok, best))


def _boxsum(h: torch.Tensor, r: int) -> torch.Tensor:
    """Sum of h over the window [k - r, k + r] (clipped), for every k."""
    n = h.shape[0]
    csum = torch.cumsum(torch.cat([torch.zeros_like(h[:1]), h]), 0)
    ar = torch.arange(n, device=h.device)
    return csum[torch.clamp(ar + r + 1, max=n)] - csum[torch.clamp_min(
        ar - r, 0)]


def detect_loop(cfg: SLAMConfig, K, mstate: MapState, f, gumbel,
                min_gap: int = 50, max_candidates: int = 8192,
                min_inliers: int = 30, matcher: Optional[Callable] = None,
                R_cur=None, t_cur=None) -> LoopDetection:
    """Match the current frame against old map points and verify.

    With `matcher` and `R_cur` / `t_cur` this is `detect_loop_db` (the
    keyframe-database path; `gumbel` (loop_candidates, hypotheses,
    loop_db_keypoints)). Without, the map-archive path: mutual-NN matching
    against a strided sample of old points (`max_candidates`), each hit
    voting for the keyframe that last observed its point; the vote
    histogram, box-smoothed over +/- `loop_region_radius` keyframes and
    divided by the pooled candidates per region (the hit rate), proposes
    the top 4 regions among old keyframes with `loop_min_votes`; each
    region runs PnP on its consistent hits (within the region or its
    covisibility neighbourhood), holding at least `loop_min_votes` and a
    `loop_consistency_frac` share of all hits, and the region with the
    most inliers wins. `gumbel` (4, hypotheses, min(max_candidates,
    capacity_pts))."""
    if matcher is not None:
        return detect_loop_db(cfg, K, mstate, f, gumbel, min_gap,
                              min_inliers, matcher, R_cur, t_cur)
    Pmax = mstate.capacity_pts
    Kmax = mstate.capacity_kf
    dev = mstate.pts_xyz.device
    cur_kf = mstate.num_kf
    rt = cfg.runtime

    old = (mstate.pts_valid & ~mstate.pts_bad
           & (mstate.pts_last_kf < cur_kf - min_gap)
           & (mstate.pts_last_kf >= 0))
    stride = max(Pmax // max_candidates, 1)
    cand = torch.arange(0, Pmax, stride, device=dev)[:max_candidates]
    cmask = old[cand]
    desc = mstate.pts_desc[cand].to(f.desc.dtype)
    m = match_ops.mutual_nn_match(desc, cmask, f.desc, f.valid,
                                  min_score=cfg.frontend.map_match_threshold)
    hit = m.matches0 >= 0

    # region vote: hits per keyframe of last observation, box-smoothed
    r = rt.loop_region_radius
    last_kf = mstate.pts_last_kf[cand]
    votes_kf = torch.where(hit, last_kf, Kmax)
    hist = _scatter(torch.zeros(Kmax, dtype=_I32, device=dev), votes_kf,
                    torch.ones_like(votes_kf), accumulate=True)
    region = _boxsum(hist, r)
    # hit rate per pooled candidate: a dense stale trail out-votes a sparse
    # genuine revisit in raw counts, not in rate
    pool_kf = torch.where(cmask, last_kf, Kmax)
    pool_reg = _boxsum(_scatter(torch.zeros(Kmax, dtype=_I32, device=dev),
                                pool_kf, torch.ones_like(pool_kf),
                                accumulate=True), r)
    rate = region.float() / torch.clamp_min(pool_reg.float(), 16.0)
    eligible = ((torch.arange(Kmax, device=dev) < cur_kf - min_gap)
                & (region >= rt.loop_min_votes))
    rate = torch.where(eligible, rate, -1.0)

    # the rate proposes, geometry decides: PnP per top region
    Q = 4
    _, centers = topk_stable(rate, Q)                              # (Q,)
    rate_q = rate[centers]
    pts = mstate.pts_xyz[cand]
    uv = f.kpts[torch.clamp(m.matches0, 0, f.kpts.shape[0] - 1).long()]
    n_hits = hit.to(_I32).sum(dtype=_I32)

    nbrs = mstate.covis_nbr[torch.clamp(centers, 0, Kmax - 1)]     # (Q, C)
    nb_idx = torch.where(nbrs >= 0, nbrs, Kmax).long()
    nb = torch.zeros((Q, Kmax + 1), dtype=torch.bool, device=dev)
    nb = nb.scatter(1, nb_idx, True)[:, :Kmax]
    near = (votes_kf[None, :] - centers[:, None]).abs() <= r
    in_nb = torch.gather(nb, 1, torch.clamp(votes_kf, 0, Kmax - 1).long()
                         .expand(Q, -1))
    consistent = hit[None, :] & (near | in_nb)                    # (Q, M)
    res = pnp.solve_pnp_ransac(
        K, pts.expand(Q, *pts.shape), uv.expand(Q, *uv.shape), consistent,
        gumbel, threshold_px=cfg.geometry.pnp_threshold_px,
        num_hypotheses=cfg.geometry.pnp_hypotheses, min_inliers=min_inliers)
    n_cons = consistent.to(_I32).sum(-1, dtype=_I32)
    v_ok = ((n_cons >= rt.loop_min_votes)
            & (n_cons.float() >= rt.loop_consistency_frac * n_hits.float()))
    ok_q = res.ok & v_ok & (rate_q > 0)
    best = torch.argmax(torch.where(ok_q, res.num_inliers, -1))
    zero = torch.zeros((), dtype=_I32, device=dev)
    return LoopDetection(
        ok=_at(ok_q, best), loop_kf=_at(centers, best).to(_I32),
        R=_at(res.R, best), t=_at(res.t, best),
        num_inliers=_at(res.num_inliers, best), cur_kf=cur_kf,
        n_vis=zero, n_good=zero, region_votes=zero, n_cons=zero,
        pnp_raw_ok=torch.zeros((), dtype=torch.bool, device=dev))


def _mv(R, v):
    return (R @ v[..., None])[..., 0]


def _edge_residual(Rs, ts, i, j, Zr, Zt, w):
    """Residuals (E, 6) of edges Z_ij ~ T_j o T_i^-1, weighted.

    The translation part compares camera centres, not world->camera
    translations: t = -R c has a |c|-metre lever arm under rotation, so a
    t-space residual would let the solve zero a metre-scale loop error with
    a milliradian rotation while every centre stays drifted."""
    Ri, ti = Rs[i], ts[i]
    Rj, tj = Rs[j], ts[j]
    Rp = Zr @ Ri
    tp = _mv(Zr, ti) + Zt
    r_rot = se3.log_so3(Rj @ Rp.transpose(-1, -2))
    c_j = -_mv(Rj.transpose(-1, -2), tj)
    c_p = -_mv(Rp.transpose(-1, -2), tp)
    return w[:, None] * torch.cat([r_rot, c_j - c_p], dim=-1)


def optimize_pose_graph(kf_R, kf_t, edge_i, edge_j, edge_Zr, edge_Zt,
                        edge_w, fixed_mask, gn_iters: int = 8,
                        cg_iters: int = 64):
    """Keyframe poses (C, 3, 3) / (C, 3) over relative-pose edges (E,)
    (x_j = Zr x_i + Zt, weight 0 masks an edge), `fixed_mask` (C,) poses
    held constant (the gauge). Returns (R, t, cost). Dense exact
    Gauss-Newton up to 6C = 4096 parameters, matrix-free CG beyond."""
    C = kf_R.shape[0]
    free = 1.0 - fixed_mask.to(torch.float32)
    ei, ej = edge_i.long(), edge_j.long()

    def apply_increment(params):
        w, dt = params
        dR = se3.exp_so3(w * free[:, None])
        return dR @ kf_R, _mv(dR, kf_t) + dt * free[:, None]

    def residuals(params):
        R, t = apply_increment(params)
        return _edge_residual(R, t, ei, ej, edge_Zr, edge_Zt,
                              edge_w).reshape(-1)

    z0 = torch.zeros((C, 3), dtype=torch.float32, device=kf_R.device)
    if 6 * C <= 4096:
        params, cost = optim.gauss_newton_dense(residuals, (z0, z0),
                                                gn_iters=gn_iters)
    else:
        params, cost = optim.gauss_newton_cg(residuals, (z0, z0),
                                             gn_iters=gn_iters,
                                             cg_iters=cg_iters)
    R, t = apply_increment(params)
    return R, t, cost


def apply_pose_graph_correction(mstate: MapState, new_R, new_t) -> MapState:
    """Write the corrected poses of the first `num_kf` keyframes and keep
    each map point's coordinates in its anchor keyframe (`pts_first_kf`),
    and each keyframe database snapshot in its own keyframe's frame."""
    Kmax = mstate.capacity_kf
    dev = mstate.kf_R.device
    kf_sel = torch.arange(Kmax, device=dev) < mstate.num_kf
    old_R, old_t = mstate.kf_R, mstate.kf_t
    kf_R = torch.where(kf_sel[:, None, None], new_R, old_R)
    kf_t = torch.where(kf_sel[:, None], new_t, old_t)

    # X' = R_new^T (R_old X + t_old - t_new) for the anchor keyframe
    anchor = torch.clamp(mstate.pts_first_kf, 0, Kmax - 1).long()
    pc = torch.einsum('pij,pj->pi', old_R[anchor], mstate.pts_xyz) \
        + old_t[anchor]
    Xn = torch.einsum('pji,pj->pi', kf_R[anchor], pc - kf_t[anchor])
    pt_sel = mstate.pts_valid & (mstate.pts_first_kf >= 0)
    pts_xyz = torch.where(pt_sel[:, None], Xn, mstate.pts_xyz)
    # Database snapshots move with their keyframe: detections after a
    # correction verify against the corrected geometry.
    dbc = torch.einsum('kij,kqj->kqi', old_R, mstate.kf_db_xyz) \
        + old_t[:, None, :]
    db_new = torch.einsum('kji,kqj->kqi', kf_R, dbc - kf_t[:, None, :])
    kf_db_xyz = torch.where(mstate.kf_db_valid[..., None], db_new,
                            mstate.kf_db_xyz)
    return mstate._replace(kf_R=kf_R, kf_t=kf_t, pts_xyz=pts_xyz,
                           kf_db_xyz=kf_db_xyz)


def close_loop(cfg: SLAMConfig, K, state, det: LoopDetection,
               max_graph_kf: int, target_kf: Optional[int] = None):
    """Host-orchestrated loop closure: sequential odometry edges from the
    current trajectory plus the verified loop edge, a pose-graph solve over
    the last `max_graph_kf` keyframes, and the correction. Returns the
    updated TrackState.

    `target_kf`: global index of the keyframe the absolute measurement
    belongs to (det.cur_kf - 1 when consumed with a lag); None = the newest
    keyframe. A revisited keyframe older than the window re-anchors the
    edge to the window's node 0: that node is gauge-fixed like every
    pre-window keyframe, and the measurement is recomputed from the
    anchor's current pose, so the edge enforces the same absolute target.

    The solve starts from the correction already spread along the chain
    (centre lerp and rotation exp(s log dR) from the anchor up to the
    target, computed in float64 on the host): a chain's smooth modes have
    near-zero curvature, and the warm start leaves the solve only the
    residual shape."""
    mstate = state.map
    dev = mstate.kf_R.device
    f32 = torch.float32
    num_kf = int(mstate.num_kf)
    C = min(num_kf, max_graph_kf)
    first = num_kf - C
    R = mstate.kf_R[first:first + C]
    t = mstate.kf_t[first:first + C]

    ei = torch.arange(C - 1, dtype=_I32, device=dev)
    Zr = torch.einsum('eij,ekj->eik', R[1:], R[:-1])          # R_j R_i^T
    Zt = t[1:] - torch.einsum('eij,ej->ei', Zr, t[:-1])
    lk = max(int(det.loop_kf) - first, 0)
    tgt = C - 1 if target_kf is None else \
        min(max(int(target_kf) - first, 0), C - 1)
    det_R = det.R.to(dev, f32)
    det_t = det.t.to(dev, f32)
    Zr_loop = det_R @ R[lk].T
    Zt_loop = det_t - Zr_loop @ t[lk]
    edge_i = torch.cat([ei, torch.full((1,), lk, dtype=_I32, device=dev)])
    edge_j = torch.cat([ei + 1,
                        torch.full((1,), tgt, dtype=_I32, device=dev)])
    edge_Zr = torch.cat([Zr, Zr_loop[None]])
    edge_Zt = torch.cat([Zt, Zt_loop[None]])
    # the loop edge weighted strongly, odometry edges 1.0
    edge_w = torch.cat([torch.ones(C - 1, dtype=f32, device=dev),
                        torch.full((1,), 4.0, dtype=f32, device=dev)])
    fixed = torch.arange(C, device=dev) == 0

    # odometry-spread warm start (float64 on the host)
    s = (np.arange(C, dtype=np.float64) / max(C - 1, 1))[:, None]
    R_np = R.cpu().numpy().astype(np.float64)
    t_np = t.cpu().numpy().astype(np.float64)
    c_np = -np.einsum('kji,kj->ki', R_np, t_np)
    det_Rn = det_R.cpu().numpy().astype(np.float64)
    det_tn = det_t.cpu().numpy().astype(np.float64)
    dc = -det_Rn.T @ det_tn - c_np[tgt]
    dRm = det_Rn @ R_np[tgt].T
    w_axis = se3.log_so3(torch.from_numpy(dRm).to(f32)).numpy().astype(
        np.float64)
    # ramp up to the target node; nodes past it stay rigid with it
    ramp = np.minimum(s / max(s[tgt, 0], 1e-9), 1.0)
    c_init = c_np + ramp * dc
    dR_init = se3.exp_so3(torch.from_numpy(w_axis * ramp).to(f32)).numpy()
    R_init = np.einsum('kij,kjl->kil', dR_init.astype(np.float64), R_np)
    t_init = -np.einsum('kij,kj->ki', R_init, c_init)

    Rn, tn, _ = optimize_pose_graph(
        torch.from_numpy(R_init).to(dev, f32),
        torch.from_numpy(t_init).to(dev, f32), edge_i, edge_j, edge_Zr,
        edge_Zt, edge_w, fixed, gn_iters=8, cg_iters=2 * C + 64)
    full_R = torch.cat([mstate.kf_R[:first], Rn, mstate.kf_R[first + C:]])
    full_t = torch.cat([mstate.kf_t[:first], tn, mstate.kf_t[first + C:]])
    new_map = apply_pose_graph_correction(mstate, full_R, full_t)
    last = torch.clamp(new_map.num_kf - 1, 0, new_map.capacity_kf - 1).long()
    return state._replace(map=new_map, R_cur=new_map.kf_R[last],
                          t_cur=new_map.kf_t[last])
