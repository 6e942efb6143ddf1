"""The tracking step: two-view bootstrap + steady-state frontend.

Counterpart of gl_slam_tpu/slam/frontend.py on the essential tracker:
match prev keyframe <-> current frame, re-observe map points (map window,
covisibility), chain the essential pose, solve the pose against the map
(3-start pose LM), gate the associations, triangulate the leftovers and
insert the keyframe. Everything stays fixed-shape: matches are index
tensors with -1 sentinels, inlier sets are masks, and a rejected frame is
a gated no-op insert, so the step needs no host read-back.

The RANSAC draws are arguments (`u` of the bootstrap; the chunk's
prologue passes each frame's essential result) instead of a PRNG key
carried in the state. The PnP tracker, motion-gated keyframing and the
merged / batched re-observation modes are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from ..config import SLAMConfig
from ..geometry import essential, projection, se3, triangulation
from ..ops import match as match_ops
from . import pose_ba, reobserve
from .state import MapState, _scatter, init_map_state, insert_keyframe

_I32 = torch.int32


class FrameFeatures(NamedTuple):
    kpts: torch.Tensor       # (N,2) float32 pixels
    desc: torch.Tensor       # (N,D) unit-norm
    valid: torch.Tensor      # (N,) bool
    frame_idx: torch.Tensor  # () int32


class TrackState(NamedTuple):
    map: MapState
    prev_kpts: torch.Tensor
    prev_desc: torch.Tensor
    prev_valid: torch.Tensor
    R_cur: torch.Tensor      # pose of the latest keyframe (world->cam)
    t_cur: torch.Tensor
    t_rel_norm: torch.Tensor  # latest inter-frame translation magnitude
    R_rel: torch.Tensor      # previous relative motion (constant velocity)
    t_rel: torch.Tensor


class TrackOutputs(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    num_matches: torch.Tensor
    num_inliers: torch.Tensor
    num_map_matches: torch.Tensor
    num_new_points: torch.Tensor
    pose_cost: torch.Tensor
    frame_ok: torch.Tensor
    num_rest: torch.Tensor
    num_tri_cheir: torch.Tensor
    num_tri_reproj: torch.Tensor
    num_assoc_prev: torch.Tensor
    num_assoc_window: torch.Tensor
    num_assoc_covis: torch.Tensor
    num_assoc_gated: torch.Tensor
    dbg_s_lm: torch.Tensor
    dbg_s_med: torch.Tensor
    dbg_err_old: torch.Tensor
    dbg_err_young: torch.Tensor
    dbg_n_old: torch.Tensor
    dbg_soft_ok: torch.Tensor
    dbg_step_ratio: torch.Tensor


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(_I32).sum(dtype=_I32)


def _check_supported(cfg: SLAMConfig) -> None:
    if cfg.runtime.tracker != "essential":
        raise NotImplementedError(
            "the PnP tracker (geometry/pnp.py) is not ported yet; see "
            "ROADMAP.md")
    if cfg.map.reobs_mode != "separate":
        raise NotImplementedError(
            f"reobs_mode={cfg.map.reobs_mode!r} is not ported yet (only "
            "'separate'); see ROADMAP.md")
    if not cfg.runtime.every_frame_keyframe:
        raise NotImplementedError(
            "motion-gated keyframing (and the chunk prologue's recovery "
            "path it needs) is not ported yet; see ROADMAP.md")


def init_track_state(cfg: SLAMConfig, device=None) -> TrackState:
    N = cfg.frontend.max_keypoints
    D = cfg.frontend.descriptor_dim
    m = init_map_state(cfg.map.max_keyframes, cfg.map.max_points, N, D,
                       cfg.map.max_obs_per_point,
                       desc_dtype=getattr(torch, cfg.map.desc_dtype),
                       loop_db=min(cfg.map.loop_db_keypoints, N),
                       device=device)
    f32 = torch.float32
    kw = dict(dtype=f32, device=device)
    return TrackState(
        map=m, prev_kpts=torch.zeros((N, 2), **kw),
        prev_desc=torch.zeros((N, D), **kw),
        prev_valid=torch.zeros((N,), dtype=torch.bool, device=device),
        R_cur=torch.eye(3, **kw), t_cur=torch.zeros(3, **kw),
        t_rel_norm=torch.ones((), **kw), R_rel=torch.eye(3, **kw),
        t_rel=torch.zeros(3, **kw))


def bootstrap_step(cfg: SLAMConfig, K, state: TrackState, f0: FrameFeatures,
                   f1: FrameFeatures, gt_scale, matches: match_ops.MatchResult,
                   u: torch.Tensor):
    """Two-view initialization: essential + cheirality from `matches`,
    translation scaled to `gt_scale`, triangulation at the bootstrap
    threshold, keyframes 0 and 1 inserted. `u`: (hypotheses, 8) RANSAC
    draws."""
    g = cfg.geometry
    dev = f0.kpts.device
    m = matches
    pair = match_ops.score_filter(m.matches0, m.mscores0,
                                  cfg.frontend.match_threshold)
    uv0, uv1, pair = match_ops.gather_matched(f0.kpts, f1.kpts, m.matches0,
                                              pair)
    ess = essential.estimate_essential(
        K, uv0, uv1, pair, u, threshold_px=g.essential_threshold_px,
        num_hypotheses=g.essential_hypotheses,
        refine_iters=g.essential_refine_iters)
    t_scaled = ess.t * gt_scale
    R0 = torch.eye(3, dtype=torch.float32, device=dev)
    t0 = torch.zeros(3, dtype=torch.float32, device=dev)
    tri = triangulation.triangulate(
        K, R0, t0, ess.R, t_scaled, uv0, uv1, mask=pair & ess.inliers,
        max_depth=g.max_depth,
        max_reproj_px=g.triangulation_reproj_bootstrap_px,
        min_parallax_deg=g.min_parallax_deg)

    N = f0.kpts.shape[0]
    none = torch.full((N,), -1, dtype=_I32, device=dev)
    ar = torch.arange(N, dtype=_I32, device=dev)
    minus1 = torch.tensor(-1, dtype=_I32, device=dev)
    mstate = insert_keyframe(
        state.map, R0, t0, f0.frame_idx, f0.kpts, f0.desc, f0.valid, none,
        torch.zeros((N, 3), device=dev),
        torch.zeros((N,), dtype=torch.bool, device=dev), none, none, minus1,
        covis_threshold=cfg.map.covis_edge_threshold)
    mstate = insert_keyframe(
        mstate, ess.R, t_scaled, f1.frame_idx, f1.kpts, f1.desc, f1.valid,
        none, tri.points, tri.valid, m.matches0, ar, minus1 + 1,
        covis_threshold=cfg.map.covis_edge_threshold)

    new_state = TrackState(
        map=mstate, prev_kpts=f1.kpts, prev_desc=f1.desc,
        prev_valid=f1.valid, R_cur=ess.R, t_cur=t_scaled,
        t_rel_norm=torch.linalg.vector_norm(t_scaled), R_rel=ess.R,
        t_rel=t_scaled)
    zf = torch.zeros((), device=dev)
    zi = torch.zeros((), dtype=_I32, device=dev)
    out = TrackOutputs(
        R=ess.R, t=t_scaled, num_matches=_count(pair),
        num_inliers=ess.num_inliers, num_map_matches=zi,
        num_new_points=_count(tri.valid), pose_cost=zf,
        frame_ok=torch.ones((), dtype=torch.bool, device=dev),
        num_rest=zi, num_tri_cheir=zi, num_tri_reproj=zi, num_assoc_prev=zi,
        num_assoc_window=zi, num_assoc_covis=zi, num_assoc_gated=zi,
        dbg_s_lm=zf, dbg_s_med=zf, dbg_err_old=zf, dbg_err_young=zf,
        dbg_n_old=zi, dbg_soft_ok=torch.ones((), dtype=torch.bool,
                                             device=dev),
        dbg_step_ratio=zf)
    return new_state, out


def track_step_impl(cfg: SLAMConfig, K, state: TrackState, f: FrameFeatures,
                    matches: match_ops.MatchResult,
                    ess_result: essential.EssentialResult, matcher=None,
                    accept_gate: Optional[torch.Tensor] = None):
    """Steady-state tracking of frame `f` against the previous keyframe.

    `matches` and `ess_result`: the prev<->cur matches and their essential
    result (the chunk prologue computes both). `matcher`: the learned
    matcher for the two re-observation passes (None = mutual-NN).
    `accept_gate`: () bool ANDed into the frame acceptance."""
    _check_supported(cfg)
    g = cfg.geometry
    dev = f.kpts.device
    N = f.kpts.shape[0]
    mstate = state.map
    Pmax, Kmax = mstate.capacity_pts, mstate.capacity_kf
    prev_kf = mstate.num_kf - 1
    prev_c = torch.clamp(prev_kf, 0, Kmax - 1).long()

    # 1. prev keyframe <-> current frame correspondences
    m = matches
    pair = match_ops.score_filter(m.matches0, m.mscores0,
                                  cfg.frontend.match_threshold)
    uv0, uv1, pair = match_ops.gather_matched(state.prev_kpts, f.kpts,
                                              m.matches0, pair)

    # 2. map re-observation through the last-W-keyframes window
    with record_function("track.reobserve_window"):
        reob = reobserve.match_map_window(cfg, K, mstate, state.R_cur,
                                          state.t_cur, f, matcher=matcher)

    # 3. essential pose chaining (constant-velocity translation scale)
    ess = ess_result
    R_pred, t_pred = se3.chain_relative(state.R_cur, state.t_cur, ess.R,
                                        ess.t * state.t_rel_norm)

    # 4. 3D-2D association. (a) matched prev keypoints with a map point
    prev_kp2mp = mstate.kf_kp2mp[prev_c]
    inl_pair = pair & ess.inliers
    mp_prev = torch.where(inl_pair, prev_kp2mp, -1)
    mp_bad = mstate.pts_bad[torch.clamp(mp_prev, 0, Pmax - 1).long()]
    mp_prev = torch.where((mp_prev >= 0) & ~mp_bad, mp_prev, -1)
    cur_rows = torch.where(mp_prev >= 0, m.matches0, N)
    reobs_mpid = _scatter(torch.full((N,), -1, dtype=_I32, device=dev),
                          cur_rows, mp_prev)
    n_assoc_a = _count(reobs_mpid >= 0)
    # (b) map-window re-observations
    reobs_mpid = torch.where(reobs_mpid >= 0, reobs_mpid, reob.reobs_mpid)
    n_assoc_b = _count(reobs_mpid >= 0) - n_assoc_a
    # (c) covisibility retrieval at the predicted pose
    if cfg.map.use_covis_retrieval:
        with record_function("track.reobserve_covis"):
            cov = reobserve.match_covisible(cfg, K, mstate, R_pred, t_pred,
                                            f, seed_mpid=reobs_mpid,
                                            already_mpid=reobs_mpid,
                                            matcher=matcher)
        reobs_mpid = torch.where(reobs_mpid >= 0, reobs_mpid,
                                 cov.reobs_mpid)
    n_assoc_c = _count(reobs_mpid >= 0) - n_assoc_a - n_assoc_b

    # 5. pose solve: three starts (essential prediction, previous pose,
    #    constant velocity), lowest final robust cost wins
    has3d = reobs_mpid >= 0
    rid = torch.clamp(reobs_mpid, 0, Pmax - 1).long()
    p3d = mstate.pts_xyz[rid]
    run_pose_ba = cfg.runtime.run_pose_ba
    age = mstate.num_kf - mstate.pts_first_kf[rid]
    pt_w = torch.where(age >= cfg.ba.pose_young_age, 1.0,
                       cfg.ba.pose_young_weight) \
        if cfg.ba.pose_young_weight < 1.0 else None
    if run_pose_ba:
        R_cv, t_cv = se3.chain_relative(state.R_cur, state.t_cur,
                                        state.R_rel, state.t_rel)
        with record_function("track.pose_lm"):
            pb = pose_ba.pose_only_ba_multi(
                K, torch.stack([R_pred, state.R_cur, R_cv]),
                torch.stack([t_pred, state.t_cur, t_cv]), p3d, f.kpts,
                has3d, iters=cfg.ba.pose_only_iters,
                cauchy_scale=cfg.ba.pose_only_cauchy_scale,
                coarse_iters=cfg.ba.pose_only_coarse_iters,
                coarse_scale_mult=cfg.ba.pose_only_coarse_mult,
                point_weights=pt_w)
        best = torch.argmin(pb.final_cost)
        R_cur, t_cur, pose_cost = pb.R[best], pb.t[best], pb.final_cost[best]
    else:
        R_cur, t_cur = R_pred, t_pred
        pose_cost = torch.zeros((), device=dev)

    # 5b. association reprojection gate + pose re-polish
    n_assoc_pre_gate = _count(has3d)
    zf = torch.zeros((), device=dev)
    dbg_err_old, dbg_err_young = zf, zf
    dbg_n_old = torch.zeros((), dtype=_I32, device=dev)
    if g.reobs_max_reproj_px > 0:
        uv_p, _, front_p = projection.project(K, R_cur, t_cur, p3d)
        err2 = ((uv_p - f.kpts) ** 2).sum(-1)
        old_m = has3d & (age >= cfg.ba.pose_young_age)
        young_m = has3d & (age < cfg.ba.pose_young_age)
        err_d = torch.sqrt(err2)
        dbg_n_old = _count(old_m)
        dbg_err_old = torch.where(old_m, err_d, 0.0).sum() \
            / torch.clamp(dbg_n_old, min=1)
        dbg_err_young = torch.where(young_m, err_d, 0.0).sum() \
            / torch.clamp(_count(young_m), min=1)
        assoc_ok = has3d & front_p & (err2 < g.reobs_max_reproj_px ** 2)
        reobs_mpid = torch.where(assoc_ok, reobs_mpid, -1)
        has3d = reobs_mpid >= 0
        if run_pose_ba and g.gate_refine_iters > 0:
            with record_function("track.pose_lm"):
                pb2 = pose_ba.pose_only_ba(
                    K, R_cur, t_cur, p3d, f.kpts, has3d,
                    iters=g.gate_refine_iters,
                    cauchy_scale=cfg.ba.pose_only_cauchy_scale,
                    point_weights=pt_w)
            R_cur, t_cur, pose_cost = pb2.R, pb2.t, pb2.final_cost

    # 5c. soft trust decision + odometry fallback
    n_3d = _count(has3d)
    soft_ok = n_3d >= 6
    if run_pose_ba:
        mean_rho = pose_cost / torch.clamp(n_3d.float(), min=1.0)
        soft_ok = soft_ok & (mean_rho < cfg.runtime.pose_accept_mean_cost)
    dbg_ratio = zf
    if cfg.runtime.pose_step_max_ratio > 1.0:
        rr = cfg.runtime.pose_step_max_ratio
        step_lm = torch.linalg.vector_norm(
            t_cur - (R_cur @ state.R_cur.T) @ state.t_cur)
        ratio = step_lm / torch.clamp(state.t_rel_norm, min=1e-3)
        dbg_ratio = ratio
        soft_ok = soft_ok & (ratio < rr) & (ratio > 1.0 / rr)
    if cfg.runtime.soft_reject_fallback:
        R_cur = torch.where(soft_ok, R_cur, R_pred)
        t_cur = torch.where(soft_ok, t_cur, t_pred)

    # 5d. SO(3) re-orthonormalization
    R_cur = se3.project_to_so3(R_cur)

    # 6. triangulate leftover inlier pairs in the pair's own frame, then
    #    anchor them to the solved current pose
    cur_idx = torch.clamp(m.matches0, 0, N - 1).long()
    is_rest = inl_pair & (prev_kp2mp < 0) & (reobs_mpid[cur_idx] < 0)
    R_prev, t_prev = mstate.kf_R[prev_c], mstate.kf_t[prev_c]
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
    s_lm = torch.linalg.vector_norm(t_cur - (R_cur @ R_prev.T) @ t_prev)
    t_rel_e = ess.t * s_lm
    tri = triangulation.triangulate(
        K, eye3, zero3, ess.R, t_rel_e, uv0, uv1, mask=is_rest,
        max_depth=g.max_depth, max_reproj_px=g.triangulation_reproj_px,
        min_parallax_deg=g.min_parallax_deg)
    tri_pts = (tri.points @ ess.R.T + t_rel_e - t_cur) @ R_cur
    tri = tri._replace(points=tri_pts)
    _, z0d, f0d = projection.project(K, R_prev, t_prev, tri_pts)
    _, _, f1d = projection.project(K, R_cur, t_cur, tri_pts)
    tri_cheir = is_rest & f0d & f1d & (z0d < g.max_depth)
    tri_reproj = tri_cheir & (tri.errors <= g.triangulation_reproj_px)

    # 7. frame acceptance gate
    frame_ok = ess.ok
    if not cfg.runtime.soft_reject_fallback:
        frame_ok = frame_ok & soft_ok
    if accept_gate is not None:
        frame_ok = frame_ok & accept_gate

    # 8. keyframe + map insertion (gated)
    with record_function("track.insert_keyframe"):
        mstate = insert_keyframe(
            mstate, R_cur, t_cur, f.frame_idx, f.kpts, f.desc, f.valid,
            reobs_mpid, tri.points, tri.valid, m.matches0,
            torch.arange(N, dtype=_I32, device=dev), prev_kf,
            covis_threshold=cfg.map.covis_edge_threshold,
            enabled=frame_ok)

    t_rel_post = t_cur - ess.R @ state.t_cur
    R_rel_post = R_cur @ state.R_cur.T
    t_rel_cv = t_cur - R_rel_post @ state.t_cur

    def sel(new, old):
        return torch.where(frame_ok, new, old)

    new_state = TrackState(
        map=mstate, prev_kpts=sel(f.kpts, state.prev_kpts),
        prev_desc=sel(f.desc, state.prev_desc),
        prev_valid=sel(f.valid, state.prev_valid),
        R_cur=sel(R_cur, state.R_cur), t_cur=sel(t_cur, state.t_cur),
        t_rel_norm=sel(torch.clamp(torch.linalg.vector_norm(t_rel_post),
                                   1e-3, 10.0), state.t_rel_norm),
        R_rel=sel(R_rel_post, state.R_rel), t_rel=sel(t_rel_cv, state.t_rel))

    out = TrackOutputs(
        R=new_state.R_cur, t=new_state.t_cur, num_matches=_count(pair),
        num_inliers=ess.num_inliers, num_map_matches=n_3d,
        num_new_points=torch.where(frame_ok, _count(tri.valid), 0),
        pose_cost=pose_cost, frame_ok=frame_ok, num_rest=_count(is_rest),
        num_tri_cheir=_count(tri_cheir), num_tri_reproj=_count(tri_reproj),
        num_assoc_prev=n_assoc_a, num_assoc_window=n_assoc_b,
        num_assoc_covis=n_assoc_c, num_assoc_gated=n_assoc_pre_gate - n_3d,
        dbg_s_lm=s_lm, dbg_s_med=s_lm, dbg_err_old=dbg_err_old,
        dbg_err_young=dbg_err_young, dbg_n_old=dbg_n_old,
        dbg_soft_ok=soft_ok, dbg_step_ratio=dbg_ratio)
    return new_state, out
