"""Map re-observation: synthetic-keypoint matching against the map.

Counterpart of gl_slam_tpu/slam/reobserve.py. Candidate map points are
projected into a pose and matched, as a synthetic keypoint set carrying
each point's latest descriptor, against the current frame. Three modes
(`cfg.map.reobs_mode`):

  * "separate" (the reference dataflow): the map-window pass
    (`match_map_window`) and the covisibility pass (`match_covisible`) each
    run their own matcher call;
  * "merged" (`match_unified`): one pass over the union of both candidate
    pools, at the predicted pose;
  * "batched" (`match_batched`): both pools keep their own projection pose
    and run as ONE matcher call over a leading set axis of 2.

Every top-k here runs on integer keys full of ties and decides which map
points and keyframes take part, so all of them go through the tie-stable
`topk_stable` (lowest index first, as `lax.top_k`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SLAMConfig
from ..geometry import projection
from ..ops import match as match_ops
from ..ops import select as select_ops
from .state import MapState, _gather, _scatter

_I32 = torch.int32


class ReobserveResult(NamedTuple):
    reobs_mpid: torch.Tensor      # (N,) map-point id per current keypoint
    num_candidates: torch.Tensor


# The covisibility pass's result under the JAX package's name (every pass
# here returns the same two fields).
CovisResult = ReobserveResult


def _col(x: torch.Tensor) -> torch.Tensor:
    """A per-stream scalar (or a 0-d one) against a (..., n) row."""
    return x[..., None]


def _candidate_points(cfg: SLAMConfig, mstate: MapState, min_last_kf,
                      max_last_kf, max_candidates: int):
    """Up to `max_candidates` map points last observed in
    [min_last_kf, max_last_kf], newest-created first -> (ids, mask)."""
    eligible = (mstate.pts_valid & ~mstate.pts_bad
                & (mstate.pts_last_kf >= _col(min_last_kf))
                & (mstate.pts_last_kf <= _col(max_last_kf)))
    return select_ops.select_newest_ids(eligible, max_candidates)


def _with_sets(x: torch.Tensor, lead: int, sets: tuple) -> torch.Tensor:
    """Frame features x (*B, N, ...) with the set axes `sets` inserted
    behind the stream axes: (*B, *sets, N, ...)."""
    for _ in sets:
        x = x.unsqueeze(lead)
    return x.expand(x.shape[:lead] + sets + x.shape[lead + len(sets):])


def _project_and_match(cfg, K, mstate, R, t, f, ids, cmask, matcher):
    """Project candidate points `ids` (..., M) at poses R (..., 3, 3),
    t (..., 3) and match each set against frame `f` in one matcher call
    (leading set dimensions allowed, behind a stream axis when there is
    one) -> (visible (..., M), accepted (..., M), matches0 (..., M))."""
    L = mstate.lead
    xyz = _gather(mstate.pts_xyz, ids.reshape(ids.shape[:L] + (-1,)), L)
    desc = _gather(mstate.pts_desc, ids.reshape(ids.shape[:L] + (-1,)), L)
    xyz = xyz.reshape(ids.shape + (3,))
    desc = desc.reshape(ids.shape + desc.shape[-1:]).to(f.desc.dtype)
    uv, _, front = projection.project(K, R, t, xyz)
    vis = cmask & front & projection.in_image(
        uv, cfg.frontend.image_height, cfg.frontend.image_width)
    sets = tuple(ids.shape[L:-1])
    kp, d1, v1 = (_with_sets(x, L, sets) for x in (f.kpts, f.desc, f.valid))
    if matcher is None:
        m = match_ops.mutual_nn_match(desc, vis, d1, v1)
    else:
        m = matcher(uv, desc, vis, kp, d1, v1)
    good = match_ops.score_filter(m.matches0, m.mscores0,
                                  cfg.frontend.map_match_threshold)
    return vis, good, m.matches0


def _scatter_hits(reobs, ids, good, matches0):
    """Write the accepted point ids onto their current keypoint rows."""
    N = reobs.shape[-1]
    return _scatter(reobs, torch.where(good, matches0, N),
                    torch.where(good, ids, -1), lead=reobs.dim() - 1)


def _none(f) -> torch.Tensor:
    return torch.full(f.kpts.shape[:-1], -1, dtype=_I32,
                      device=f.kpts.device)


def _match_candidates(cfg, K, mstate, R, t, f, ids, cmask, matcher):
    """Project candidate points `ids` at pose (R, t), match them against
    frame `f` and scatter the accepted point ids onto its keypoint rows."""
    vis, good, matches0 = _project_and_match(cfg, K, mstate, R, t, f, ids,
                                             cmask, matcher)
    return ReobserveResult(reobs_mpid=_scatter_hits(_none(f), ids, good,
                                                    matches0),
                           num_candidates=vis.to(_I32).sum(-1, dtype=_I32))


def match_map_window(cfg: SLAMConfig, K, mstate: MapState, R_prev, t_prev,
                     f, matcher=None) -> ReobserveResult:
    """Match the window's map points not observed in the previous keyframe
    (projected into the previous pose) against the current frame."""
    prev_kf = mstate.num_kf - 1
    lo = torch.clamp(prev_kf - cfg.map.map_match_window, min=0)
    ids, mask = _candidate_points(cfg, mstate, lo, prev_kf - 1,
                                  cfg.map.covis_max_points)
    return _match_candidates(cfg, K, mstate, R_prev, t_prev, f, ids, mask,
                             matcher)


def _covis_member(cfg: SLAMConfig, mstate: MapState,
                  seed_mpid: torch.Tensor) -> torch.Tensor:
    """(Pmax,) membership of the covisibility expansion: seed points ->
    top-K1 observer keyframes -> top covisible neighbours each -> global
    top-K2 -> union of those keyframes' map points."""
    L = mstate.lead
    B = mstate.num_kf.shape
    Kmax = mstate.capacity_kf
    Pmax = mstate.capacity_pts
    dev = seed_mpid.device
    obs_kf = _gather(mstate.pts_obs_kf, torch.clamp(seed_mpid, 0, Pmax - 1),
                     L)
    ok = (seed_mpid >= 0)[..., None] & (obs_kf >= 0)
    ids = torch.where(ok, obs_kf, Kmax).reshape(B + (-1,))
    hist = _scatter(torch.zeros(B + (Kmax,), dtype=_I32, device=dev), ids,
                    torch.ones_like(ids), accumulate=True, lead=L)
    w1, k1 = select_ops.topk_stable(hist, cfg.map.covis_k1)
    k1 = torch.where(w1 > 0, k1, -1)
    k1c = torch.clamp(k1, 0, Kmax - 1)
    nbr = _gather(mstate.covis_nbr, k1c, L)                      # (K1, C)
    nbr_w = torch.where((k1[..., None] >= 0) & (nbr >= 0),
                        _gather(mstate.covis_w, k1c, L), -1)
    top_w, top_i = select_ops.topk_stable(nbr_w, cfg.map.covis_top_neighbors)
    cand_kf = torch.gather(nbr, -1, top_i).reshape(B + (-1,))
    k2_w, k2_i = select_ops.topk_stable(top_w.reshape(B + (-1,)),
                                        cfg.map.covis_k2)
    k2 = torch.where(k2_w > 0, torch.gather(cand_kf, -1, k2_i), -1)
    kf_union = torch.cat([k1.to(_I32), k2.to(_I32)], -1)
    rows = _gather(mstate.kf_kp2mp, torch.clamp(kf_union, 0, Kmax - 1), L)
    flat = torch.where((kf_union >= 0)[..., None], rows, -1).reshape(
        B + (-1,))
    return _scatter(torch.zeros(B + (Pmax,), dtype=torch.bool, device=dev),
                    torch.where(flat >= 0, flat, Pmax), True, lead=L)


def _covis_candidates(cfg, mstate, seed_mpid, exclude_mpid, window=None):
    """Up to `covis_max_points` points of the covisibility expansion of
    `seed_mpid` (or'ed with the membership `window`), minus the points
    `exclude_mpid`, newest-created first -> (ids, mask)."""
    member = _covis_member(cfg, mstate, seed_mpid)
    if window is not None:
        member = window | member
    member = _scatter(member, torch.where(exclude_mpid >= 0, exclude_mpid,
                                          mstate.capacity_pts), False,
                      lead=mstate.lead)
    eligible = member & mstate.pts_valid & ~mstate.pts_bad
    return select_ops.select_newest_ids(eligible, cfg.map.covis_max_points)


def match_covisible(cfg: SLAMConfig, K, mstate: MapState, R_pred, t_pred, f,
                    seed_mpid, already_mpid, matcher=None) -> ReobserveResult:
    """Covisibility retrieval: the expansion of the currently matched
    points, minus points already matched this frame, projected at the
    predicted pose and matched against the current frame."""
    cand, cmask = _covis_candidates(cfg, mstate, seed_mpid, already_mpid)
    return _match_candidates(cfg, K, mstate, R_pred, t_pred, f, cand, cmask,
                             matcher)


def match_unified(cfg: SLAMConfig, K, mstate: MapState, R_pred, t_pred, f,
                  seed_mpid, matcher=None) -> ReobserveResult:
    """Merged re-observation (`reobs_mode="merged"`): ONE pass over the
    union of the map window (points last seen in the window's keyframes
    before the previous one) and the covisibility expansion of
    `seed_mpid`, minus the seed points, projected at the PREDICTED pose."""
    prev_kf = mstate.num_kf - 1
    lo = torch.clamp(prev_kf - cfg.map.map_match_window, min=0)
    window = (mstate.pts_last_kf >= _col(lo)) \
        & (mstate.pts_last_kf <= _col(prev_kf - 1))
    cand, cmask = _covis_candidates(cfg, mstate, seed_mpid, seed_mpid,
                                    window=window)
    return _match_candidates(cfg, K, mstate, R_pred, t_pred, f, cand, cmask,
                             matcher)


def match_batched(cfg: SLAMConfig, K, mstate: MapState, R_prev, t_prev,
                  R_pred, t_pred, f, seed_mpid,
                  matcher=None) -> ReobserveResult:
    """Both re-observation passes as ONE matcher call over a leading set
    axis of 2 (`reobs_mode="batched"`; behind the stream axis when there
    is one): the window set projected at the PREVIOUS pose (as
    match_map_window), the covisibility set at the PREDICTED pose (as
    match_covisible, but without excluding the window pass's hits: that
    exclusion is what makes the separate passes serial). The seed points
    are excluded from the covisibility pool. Covisibility hits are written
    first and window hits second, so a window hit wins a keypoint both sets
    matched."""
    prev_kf = mstate.num_kf - 1
    lo = torch.clamp(prev_kf - cfg.map.map_match_window, min=0)
    ids_w, mask_w = _candidate_points(cfg, mstate, lo, prev_kf - 1,
                                      cfg.map.covis_max_points)
    ids_c, mask_c = _covis_candidates(cfg, mstate, seed_mpid, seed_mpid)
    ids2 = torch.stack([ids_w, ids_c.to(ids_w.dtype)], -2)
    vis, good, matches0 = _project_and_match(
        cfg, K, mstate, torch.stack([R_prev, R_pred], -3),
        torch.stack([t_prev, t_pred], -2), f, ids2,
        torch.stack([mask_w, mask_c], -2), matcher)
    reobs = _none(f)
    reobs = _scatter_hits(reobs, ids2[..., 1, :], good[..., 1, :],
                          matches0[..., 1, :])
    reobs = _scatter_hits(reobs, ids2[..., 0, :], good[..., 0, :],
                          matches0[..., 0, :])
    return ReobserveResult(
        reobs_mpid=reobs,
        num_candidates=vis.to(_I32).sum((-2, -1), dtype=_I32))
