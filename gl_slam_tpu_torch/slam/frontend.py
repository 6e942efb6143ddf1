"""The tracking step: two-view bootstrap + steady-state frontend.

Counterpart of gl_slam_tpu/slam/frontend.py: match prev keyframe <->
current frame, re-observe map points (map window and covisibility, in
separate, merged or batched passes: slam/reobserve.py), predict the pose
(essential chaining, or the previous pose under the PnP tracker, which
then solves PnP RANSAC on the 3D-2D set), solve the pose against the map
(3-start pose LM), gate the associations, triangulate the leftovers and
insert the keyframe, every frame or, with `every_frame_keyframe=False`,
the frames that pass the keyframe motion filter. Everything stays
fixed-shape: matches are index tensors with -1 sentinels, inlier sets are
masks, and a rejected frame is a gated no-op insert, so the step needs no
host read-back.

Two callers: the chunk's prologue passes each frame's matches and
essential result (slam/fused.py); the per-frame route (`track_step`,
slam/pipeline.py) passes neither, and the step then matches the previous
keyframe's descriptors against the frame's by mutual nearest neighbours
(or takes the caller's learned matches) and runs the essential RANSAC
itself. The random draws are arguments instead of a PRNG key carried in
the state: the essential RANSAC's uniforms (`u`, (hypotheses, 8)) and the
PnP RANSAC's Gumbels (`pnp_gumbel`, (pnp_hypotheses, N)).

Every function also runs S independent streams at once on a leading
stream axis (`init_track_state(..., num_streams=S)`): states, features,
draws and gates carry it, a per-stream scalar becomes an (S,) tensor, and
no operation mixes streams (slam/state.py offsets each stream's table
reads and writes). This is the JAX package's `vmap` over the stream axis
(parallel/multistream.py): one matcher call and one fused assignment
cover all S streams, so a kernel launch carries S frames.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing
from ..config import SLAMConfig
from ..geometry import essential, pnp, projection, se3, triangulation
from ..ops import match as match_ops
from . import pose_ba, reobserve
from .state import (MapState, _at, _gather, _scatter, _where,
                    init_map_state, insert_keyframe, map_state_from_numpy,
                    stack_streams)

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
    # (N, P, P) image patches around the previous keyframe's keypoints,
    # carried only under pair-conditioned sub-pixel refinement
    # (models/subpix.PairSubpixHead); None otherwise.
    prev_patches: Optional[torch.Tensor] = None


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
    """Set entries along the last axis (per stream under a stream axis)."""
    return mask.to(_I32).sum(-1, dtype=_I32)


def init_track_state(cfg: SLAMConfig, device=None,
                     patch: Optional[int] = None,
                     num_streams: Optional[int] = None) -> TrackState:
    """`patch`: side of the carried previous-frame patches, set to the
    PairSubpixHead's patch size when pair-conditioned refinement runs.
    `num_streams` S: S empty states on a leading stream axis."""
    N = cfg.frontend.max_keypoints
    D = cfg.frontend.descriptor_dim
    m = init_map_state(cfg.map.max_keyframes, cfg.map.max_points, N, D,
                       cfg.map.max_obs_per_point,
                       desc_dtype=getattr(torch, cfg.map.desc_dtype),
                       loop_db=min(cfg.map.loop_db_keypoints, N),
                       device=device)
    f32 = torch.float32
    kw = dict(dtype=f32, device=device)
    st = TrackState(
        map=m, prev_kpts=torch.zeros((N, 2), **kw),
        prev_desc=torch.zeros((N, D), **kw),
        prev_valid=torch.zeros((N,), dtype=torch.bool, device=device),
        R_cur=torch.eye(3, **kw), t_cur=torch.zeros(3, **kw),
        t_rel_norm=torch.ones((), **kw), R_rel=torch.eye(3, **kw),
        t_rel=torch.zeros(3, **kw),
        prev_patches=None if patch is None
        else torch.zeros((N, patch, patch), **kw))
    return st if num_streams is None else stack_streams(st, num_streams)


def track_state_from_numpy(fields, device=None) -> TrackState:
    """Build a `TrackState` from numpy arrays: `fields` is a mapping or a
    named tuple with this class's field names, `map` holding the map's
    fields (state.map_state_from_numpy). Other fields (a PRNG key, image
    patches) are ignored; a missing `R_rel` / `t_rel` becomes the identity
    motion."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()

    def f32(name, default=None):
        a = fields.get(name)
        if a is None:
            a = default
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return TrackState(
        map=map_state_from_numpy(fields["map"], device),
        prev_kpts=f32("prev_kpts"), prev_desc=f32("prev_desc"),
        prev_valid=torch.from_numpy(
            np.array(fields["prev_valid"], dtype=bool)).to(device),
        R_cur=f32("R_cur"), t_cur=f32("t_cur"), t_rel_norm=f32("t_rel_norm"),
        R_rel=f32("R_rel", np.eye(3)), t_rel=f32("t_rel", np.zeros(3)))


def bootstrap_step(cfg: SLAMConfig, K, state: TrackState, f0: FrameFeatures,
                   f1: FrameFeatures, gt_scale,
                   matches: Optional[match_ops.MatchResult] = None,
                   u: Optional[torch.Tensor] = None,
                   patches1: Optional[torch.Tensor] = None):
    """Two-view initialization: essential + cheirality from `matches`
    (None: mutual nearest neighbours on the descriptors), translation
    scaled to `gt_scale`, triangulation at the bootstrap threshold,
    keyframes 0 and 1 inserted. `u`: (hypotheses, 8) RANSAC draws.
    `patches1`: frame 1's image patches, carried for the pair sub-pixel
    head (None keeps the state's). Under a stream axis `gt_scale` and the
    frame indices are (S,)."""
    if u is None:
        raise ValueError("bootstrap_step needs the RANSAC draws `u`")
    g = cfg.geometry
    dev = f0.kpts.device
    m = matches if matches is not None else match_ops.mutual_nn_match(
        f0.desc, f0.valid, f1.desc, f1.valid)
    pair = match_ops.score_filter(m.matches0, m.mscores0,
                                  cfg.frontend.match_threshold)
    uv0, uv1, pair = match_ops.gather_matched(f0.kpts, f1.kpts, m.matches0,
                                              pair)
    ess = essential.estimate_essential(
        K, uv0, uv1, pair, u, threshold_px=g.essential_threshold_px,
        num_hypotheses=g.essential_hypotheses,
        refine_iters=g.essential_refine_iters)
    lead = f0.kpts.shape[:-2]
    t_scaled = ess.t * torch.as_tensor(gt_scale, dtype=torch.float32,
                                       device=dev)[..., None]
    R0 = torch.eye(3, dtype=torch.float32, device=dev)
    t0 = torch.zeros(3, dtype=torch.float32, device=dev)
    tri = triangulation.triangulate(
        K, R0, t0, ess.R, t_scaled, uv0, uv1, mask=pair & ess.inliers,
        max_depth=g.max_depth,
        max_reproj_px=g.triangulation_reproj_bootstrap_px,
        min_parallax_deg=g.min_parallax_deg)

    N = f0.kpts.shape[-2]
    none = torch.full(lead + (N,), -1, dtype=_I32, device=dev)
    ar = torch.arange(N, dtype=_I32, device=dev).expand(lead + (N,))
    minus1 = torch.full(lead, -1, dtype=_I32, device=dev)
    mstate = insert_keyframe(
        state.map, R0.expand(lead + (3, 3)), t0.expand(lead + (3,)),
        f0.frame_idx, f0.kpts, f0.desc, f0.valid, none,
        torch.zeros(lead + (N, 3), device=dev),
        torch.zeros(lead + (N,), dtype=torch.bool, device=dev), none, none,
        minus1, covis_threshold=cfg.map.covis_edge_threshold)
    mstate = insert_keyframe(
        mstate, ess.R, t_scaled, f1.frame_idx, f1.kpts, f1.desc, f1.valid,
        none, tri.points, tri.valid, m.matches0, ar, minus1 + 1,
        covis_threshold=cfg.map.covis_edge_threshold)

    new_state = TrackState(
        map=mstate, prev_kpts=f1.kpts, prev_desc=f1.desc,
        prev_valid=f1.valid, R_cur=ess.R, t_cur=t_scaled,
        t_rel_norm=torch.linalg.vector_norm(t_scaled, dim=-1), R_rel=ess.R,
        t_rel=t_scaled,
        prev_patches=state.prev_patches if patches1 is None else patches1)
    zf = torch.zeros(lead, device=dev)
    zi = torch.zeros(lead, dtype=_I32, device=dev)
    out = TrackOutputs(
        R=ess.R, t=t_scaled, num_matches=_count(pair),
        num_inliers=ess.num_inliers, num_map_matches=zi,
        num_new_points=_count(tri.valid), pose_cost=zf,
        frame_ok=torch.ones(lead, dtype=torch.bool, device=dev),
        num_rest=zi, num_tri_cheir=zi, num_tri_reproj=zi, num_assoc_prev=zi,
        num_assoc_window=zi, num_assoc_covis=zi, num_assoc_gated=zi,
        dbg_s_lm=zf, dbg_s_med=zf, dbg_err_old=zf, dbg_err_young=zf,
        dbg_n_old=zi, dbg_soft_ok=torch.ones(lead, dtype=torch.bool,
                                             device=dev),
        dbg_step_ratio=zf)
    return new_state, out


def track_step_impl(cfg: SLAMConfig, K, state: TrackState, f: FrameFeatures,
                    matches: Optional[match_ops.MatchResult] = None,
                    ess_result: Optional[essential.EssentialResult] = None,
                    matcher=None, accept_gate: Optional[torch.Tensor] = None,
                    patches: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None,
                    pnp_gumbel: Optional[torch.Tensor] = None):
    """Steady-state tracking of frame `f` against the previous keyframe.

    `matches`: the prev<->cur matches (None: mutual nearest neighbours on
    the descriptors). `ess_result`: their essential result, as the chunk
    prologue computes it; None runs the RANSAC here on the draws `u`
    ((hypotheses, 8)). `matcher`: the learned matcher for the
    re-observation passes (None = mutual-NN). `accept_gate`: () bool ANDed
    into the frame acceptance. `patches`: the frame's image patches,
    carried into the state when the frame is accepted (pair sub-pixel
    refinement).

    The PnP tracker (`runtime.tracker="pnp"`) takes neither `ess_result`
    nor `u`: it predicts the previous pose, solves PnP RANSAC on the 3D-2D
    set with the Gumbel draws `pnp_gumbel` ((pnp_hypotheses, N)) and starts
    the pose LM from its pose."""
    g = cfg.geometry
    use_pnp = cfg.runtime.tracker == "pnp"
    if use_pnp and pnp_gumbel is None:
        raise ValueError("the PnP tracker needs the Gumbel draws "
                         "`pnp_gumbel`")
    if not use_pnp and ess_result is None and u is None:
        raise ValueError("track_step_impl needs `ess_result` or the RANSAC "
                         "draws `u`")
    mode = cfg.map.reobs_mode
    one_pass = mode in ("merged", "batched")
    dev = f.kpts.device
    N = f.kpts.shape[-2]
    mstate = state.map
    L = mstate.lead
    lead = mstate.num_kf.shape
    Pmax, Kmax = mstate.capacity_pts, mstate.capacity_kf
    prev_kf = mstate.num_kf - 1
    prev_c = torch.clamp(prev_kf, 0, Kmax - 1).long()

    # 1. prev keyframe <-> current frame correspondences
    m = matches if matches is not None else match_ops.mutual_nn_match(
        state.prev_desc, state.prev_valid, f.desc, f.valid)
    pair = match_ops.score_filter(m.matches0, m.mscores0,
                                  cfg.frontend.match_threshold)
    uv0, uv1, pair = match_ops.gather_matched(state.prev_kpts, f.kpts,
                                              m.matches0, pair)

    # 2. map re-observation through the last-W-keyframes window (in merged
    #    and batched mode it joins the pass after the pose prediction)
    if not one_pass:
        with tracing.span("track.reobserve_window"):
            reob = reobserve.match_map_window(cfg, K, mstate, state.R_cur,
                                              state.t_cur, f,
                                              matcher=matcher)

    # 3. pose prediction: the previous pose (PnP), else essential chaining
    #    with the constant-velocity translation scale
    if use_pnp:
        R_pred, t_pred = state.R_cur, state.t_cur
        geom_inliers, geom_num_inliers = pair, _count(pair)
        geom_ok = torch.ones(lead, dtype=torch.bool, device=dev)
        R_chain = torch.eye(3, dtype=torch.float32, device=dev)
    else:
        ess = ess_result
        if ess is None:
            with tracing.span("track.essential"):
                ess = essential.estimate_essential(
                    K, uv0, uv1, pair, u,
                    threshold_px=g.essential_threshold_px,
                    num_hypotheses=g.essential_hypotheses,
                    refine_iters=g.essential_refine_iters)
        R_pred, t_pred = se3.chain_relative(
            state.R_cur, state.t_cur, ess.R,
            ess.t * state.t_rel_norm[..., None])
        geom_inliers, geom_num_inliers = ess.inliers, ess.num_inliers
        geom_ok, R_chain = ess.ok, ess.R

    # 4. 3D-2D association. (a) matched prev keypoints with a map point
    prev_kp2mp = _at(mstate.kf_kp2mp, prev_c, L)
    inl_pair = pair & geom_inliers
    mp_prev = torch.where(inl_pair, prev_kp2mp, -1)
    mp_bad = _gather(mstate.pts_bad, torch.clamp(mp_prev, 0, Pmax - 1), L)
    mp_prev = torch.where((mp_prev >= 0) & ~mp_bad, mp_prev, -1)
    cur_rows = torch.where(mp_prev >= 0, m.matches0, N)
    reobs_mpid = _scatter(torch.full(lead + (N,), -1, dtype=_I32,
                                     device=dev), cur_rows, mp_prev, lead=L)
    n_assoc_a = _count(reobs_mpid >= 0)
    if one_pass:
        # (b)+(c) in one matcher call, seeded by (a) at the predicted pose
        with tracing.span("track.reobserve"):
            if mode == "merged":
                both = reobserve.match_unified(
                    cfg, K, mstate, R_pred, t_pred, f, seed_mpid=reobs_mpid,
                    matcher=matcher)
            else:
                both = reobserve.match_batched(
                    cfg, K, mstate, state.R_cur, state.t_cur, R_pred, t_pred,
                    f, seed_mpid=reobs_mpid, matcher=matcher)
        reobs_mpid = torch.where(reobs_mpid >= 0, reobs_mpid,
                                 both.reobs_mpid)
        n_assoc_b = _count(reobs_mpid >= 0) - n_assoc_a
        n_assoc_c = torch.zeros(lead, dtype=_I32, device=dev)
    else:
        # (b) map-window re-observations
        reobs_mpid = torch.where(reobs_mpid >= 0, reobs_mpid,
                                 reob.reobs_mpid)
        n_assoc_b = _count(reobs_mpid >= 0) - n_assoc_a
        # (c) covisibility retrieval at the predicted pose
        if cfg.map.use_covis_retrieval:
            with tracing.span("track.reobserve_covis"):
                cov = reobserve.match_covisible(
                    cfg, K, mstate, R_pred, t_pred, f, seed_mpid=reobs_mpid,
                    already_mpid=reobs_mpid, matcher=matcher)
            reobs_mpid = torch.where(reobs_mpid >= 0, reobs_mpid,
                                     cov.reobs_mpid)
        n_assoc_c = _count(reobs_mpid >= 0) - n_assoc_a - n_assoc_b

    # 5. pose solve: three starts (the prediction or the PnP pose, the
    #    previous pose, constant velocity), lowest final robust cost wins
    has3d = reobs_mpid >= 0
    rid = torch.clamp(reobs_mpid, 0, Pmax - 1)
    p3d = _gather(mstate.pts_xyz, rid, L)
    run_pose_ba = cfg.runtime.run_pose_ba
    age = mstate.num_kf[..., None] - _gather(mstate.pts_first_kf, rid, L)
    pt_w = torch.where(age >= cfg.ba.pose_young_age, 1.0,
                       cfg.ba.pose_young_weight) \
        if cfg.ba.pose_young_weight < 1.0 else None
    if use_pnp:
        # absolute pose from PnP RANSAC on the 3D-2D set; its outliers
        # lose their association
        with tracing.span("track.pnp"):
            pr = pnp.solve_pnp_ransac(K, p3d, f.kpts, has3d, pnp_gumbel,
                                      threshold_px=g.pnp_threshold_px,
                                      num_hypotheses=g.pnp_hypotheses)
        reobs_mpid = torch.where(pr.inliers, reobs_mpid, -1)
        has3d = reobs_mpid >= 0
        R_init, t_init = pr.R, pr.t
    else:
        R_init, t_init = R_pred, t_pred
    if run_pose_ba:
        R_cv, t_cv = se3.chain_relative(state.R_cur, state.t_cur,
                                        state.R_rel, state.t_rel)
        with tracing.span("track.pose_lm"):
            pb = pose_ba.pose_only_ba_multi(
                K, torch.stack([R_init, state.R_cur, R_cv], -3),
                torch.stack([t_init, state.t_cur, t_cv], -2), p3d, f.kpts,
                has3d, iters=cfg.ba.pose_only_iters,
                cauchy_scale=cfg.ba.pose_only_cauchy_scale,
                coarse_iters=cfg.ba.pose_only_coarse_iters,
                coarse_scale_mult=cfg.ba.pose_only_coarse_mult,
                point_weights=pt_w)
        best = torch.argmin(pb.final_cost, dim=-1)
        R_cur, t_cur, pose_cost = (_at(pb.R, best, L), _at(pb.t, best, L),
                                   _at(pb.final_cost, best, L))
    else:
        R_cur, t_cur = R_init, t_init
        pose_cost = torch.zeros(lead, device=dev)

    # 5b. association reprojection gate + pose re-polish
    n_assoc_pre_gate = _count(has3d)
    zf = torch.zeros(lead, device=dev)
    dbg_err_old, dbg_err_young = zf, zf
    dbg_n_old = torch.zeros(lead, dtype=_I32, device=dev)
    if g.reobs_max_reproj_px > 0:
        uv_p, _, front_p = projection.project(K, R_cur, t_cur, p3d)
        err2 = ((uv_p - f.kpts) ** 2).sum(-1)
        old_m = has3d & (age >= cfg.ba.pose_young_age)
        young_m = has3d & (age < cfg.ba.pose_young_age)
        err_d = torch.sqrt(err2)
        dbg_n_old = _count(old_m)
        dbg_err_old = torch.where(old_m, err_d, 0.0).sum(-1) \
            / torch.clamp(dbg_n_old, min=1)
        dbg_err_young = torch.where(young_m, err_d, 0.0).sum(-1) \
            / torch.clamp(_count(young_m), min=1)
        assoc_ok = has3d & front_p & (err2 < g.reobs_max_reproj_px ** 2)
        reobs_mpid = torch.where(assoc_ok, reobs_mpid, -1)
        has3d = reobs_mpid >= 0
        if run_pose_ba and g.gate_refine_iters > 0:
            with tracing.span("track.pose_lm"):
                pb2 = pose_ba.pose_only_ba(
                    K, R_cur, t_cur, p3d, f.kpts, has3d,
                    iters=g.gate_refine_iters,
                    cauchy_scale=cfg.ba.pose_only_cauchy_scale,
                    point_weights=pt_w)
            R_cur, t_cur, pose_cost = pb2.R, pb2.t, pb2.final_cost

    # 5c. soft trust decision + odometry fallback (the step-ratio check and
    #     the fallback are the essential tracker's)
    n_3d = _count(has3d)
    soft_ok = n_3d >= 6
    if run_pose_ba:
        mean_rho = pose_cost / torch.clamp(n_3d.float(), min=1.0)
        soft_ok = soft_ok & (mean_rho < cfg.runtime.pose_accept_mean_cost)
    dbg_ratio = zf
    if not use_pnp and cfg.runtime.pose_step_max_ratio > 1.0:
        rr = cfg.runtime.pose_step_max_ratio
        step_lm = torch.linalg.vector_norm(
            t_cur - se3.mv(R_cur @ state.R_cur.transpose(-1, -2),
                           state.t_cur), dim=-1)
        ratio = step_lm / torch.clamp(state.t_rel_norm, min=1e-3)
        dbg_ratio = ratio
        soft_ok = soft_ok & (ratio < rr) & (ratio > 1.0 / rr)
    if not use_pnp and cfg.runtime.soft_reject_fallback:
        R_cur = _where(soft_ok, R_cur, R_pred)
        t_cur = _where(soft_ok, t_cur, t_pred)

    # 5d. SO(3) re-orthonormalization
    R_cur = se3.project_to_so3(R_cur)

    # 6. triangulate leftover inlier pairs: between the two map poses
    #    (PnP), else in the pair's own frame and then anchored to the solved
    #    current pose
    cur_idx = torch.clamp(m.matches0, 0, N - 1).long()
    is_rest = inl_pair & (prev_kp2mp < 0) \
        & (torch.gather(reobs_mpid, -1, cur_idx) < 0)
    R_prev, t_prev = _at(mstate.kf_R, prev_c, L), _at(mstate.kf_t, prev_c, L)
    if use_pnp:
        tri = triangulation.triangulate(
            K, R_prev, t_prev, R_cur, t_cur, uv0, uv1, mask=is_rest,
            max_depth=g.max_depth, max_reproj_px=g.triangulation_reproj_px,
            min_parallax_deg=g.min_parallax_deg)
        s_lm = zf
    else:
        eye3 = torch.eye(3, dtype=torch.float32, device=dev)
        zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
        s_lm = torch.linalg.vector_norm(
            t_cur - se3.mv(R_cur @ R_prev.transpose(-1, -2), t_prev), dim=-1)
        t_rel_e = ess.t * s_lm[..., None]
        tri = triangulation.triangulate(
            K, eye3, zero3, ess.R, t_rel_e, uv0, uv1, mask=is_rest,
            max_depth=g.max_depth, max_reproj_px=g.triangulation_reproj_px,
            min_parallax_deg=g.min_parallax_deg)
        tri = tri._replace(points=(
            tri.points @ ess.R.transpose(-1, -2) + t_rel_e[..., None, :]
            - t_cur[..., None, :]) @ R_cur)
    _, z0d, f0d = projection.project(K, R_prev, t_prev, tri.points)
    _, _, f1d = projection.project(K, R_cur, t_cur, tri.points)
    tri_cheir = is_rest & f0d & f1d & (z0d < g.max_depth)
    tri_reproj = tri_cheir & (tri.errors <= g.triangulation_reproj_px)

    # 7. frame acceptance gate
    frame_ok = geom_ok
    if use_pnp or not cfg.runtime.soft_reject_fallback:
        frame_ok = frame_ok & soft_ok
    if accept_gate is not None:
        frame_ok = frame_ok & accept_gate
    if use_pnp:
        frame_ok = frame_ok & pr.ok
    if not cfg.runtime.every_frame_keyframe:
        # keyframe motion filter: low-motion frames are skipped
        t_rel_mag = torch.linalg.vector_norm(
            t_cur - se3.mv(R_chain, state.t_cur), dim=-1)
        frame_ok = frame_ok & (
            (t_rel_mag > cfg.runtime.gt_mag_filter)
            | (se3.rotation_angle_deg(R_chain) > cfg.runtime.gt_rot_filter))

    # 8. keyframe + map insertion (gated)
    with tracing.span("track.insert_keyframe"):
        mstate = insert_keyframe(
            mstate, R_cur, t_cur, f.frame_idx, f.kpts, f.desc, f.valid,
            reobs_mpid, tri.points, tri.valid, m.matches0,
            torch.arange(N, dtype=_I32, device=dev).expand(lead + (N,)),
            prev_kf,
            covis_threshold=cfg.map.covis_edge_threshold,
            enabled=frame_ok)

    t_rel_post = t_cur - se3.mv(R_chain, state.t_cur)
    R_rel_post = R_cur @ state.R_cur.transpose(-1, -2)
    t_rel_cv = t_cur - se3.mv(R_rel_post, state.t_cur)

    def sel(new, old):
        return _where(frame_ok, new, old)

    new_state = TrackState(
        map=mstate, prev_kpts=sel(f.kpts, state.prev_kpts),
        prev_desc=sel(f.desc, state.prev_desc),
        prev_valid=sel(f.valid, state.prev_valid),
        R_cur=sel(R_cur, state.R_cur), t_cur=sel(t_cur, state.t_cur),
        t_rel_norm=sel(torch.clamp(torch.linalg.vector_norm(t_rel_post,
                                                            dim=-1),
                                   1e-3, 10.0), state.t_rel_norm),
        R_rel=sel(R_rel_post, state.R_rel), t_rel=sel(t_rel_cv, state.t_rel),
        prev_patches=None if patches is None or state.prev_patches is None
        else sel(patches, state.prev_patches))

    out = TrackOutputs(
        R=new_state.R_cur, t=new_state.t_cur, num_matches=_count(pair),
        num_inliers=geom_num_inliers, num_map_matches=n_3d,
        num_new_points=torch.where(frame_ok, _count(tri.valid), 0),
        pose_cost=pose_cost, frame_ok=frame_ok, num_rest=_count(is_rest),
        num_tri_cheir=_count(tri_cheir), num_tri_reproj=_count(tri_reproj),
        num_assoc_prev=n_assoc_a, num_assoc_window=n_assoc_b,
        num_assoc_covis=n_assoc_c, num_assoc_gated=n_assoc_pre_gate - n_3d,
        dbg_s_lm=s_lm, dbg_s_med=s_lm, dbg_err_old=dbg_err_old,
        dbg_err_young=dbg_err_young, dbg_n_old=dbg_n_old,
        dbg_soft_ok=soft_ok, dbg_step_ratio=dbg_ratio)
    return new_state, out


def track_step(cfg: SLAMConfig, K, state: TrackState, f: FrameFeatures, u,
               matches: Optional[match_ops.MatchResult] = None,
               matcher=None, pnp_gumbel: Optional[torch.Tensor] = None):
    """The standalone per-frame step: `track_step_impl` with the essential
    RANSAC inside the step on the frame's draws `u` (hypotheses, 8), or
    under the PnP tracker the PnP RANSAC on its Gumbel draws `pnp_gumbel`
    (pnp_hypotheses, N; `u` unused, may be None). `matches`: the caller's
    prev<->cur matches (the learned matcher); None matches by mutual
    nearest neighbours. `matcher`: the learned matcher of the
    re-observation passes (None = mutual-NN)."""
    return track_step_impl(cfg, K, state, f, matches=matches,
                           matcher=matcher, u=u, pnp_gumbel=pnp_gumbel)
