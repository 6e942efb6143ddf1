"""Map re-observation: synthetic-keypoint matching against the map.

Counterpart of gl_slam_tpu/slam/reobserve.py in its "separate" mode (the
reference dataflow: the map-window pass and the covisibility pass each run
their own matcher). Candidate map points are projected into a pose and
matched, as a synthetic keypoint set carrying each point's latest
descriptor, against the current frame. The merged and batched modes are
not ported yet.

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
from .state import MapState, _scatter

_I32 = torch.int32


class ReobserveResult(NamedTuple):
    reobs_mpid: torch.Tensor      # (N,) map-point id per current keypoint
    num_candidates: torch.Tensor


def _candidate_points(cfg: SLAMConfig, mstate: MapState, min_last_kf,
                      max_last_kf, max_candidates: int):
    """Up to `max_candidates` map points last observed in
    [min_last_kf, max_last_kf], newest-created first -> (ids, mask)."""
    eligible = (mstate.pts_valid & ~mstate.pts_bad
                & (mstate.pts_last_kf >= min_last_kf)
                & (mstate.pts_last_kf <= max_last_kf))
    return select_ops.select_newest_ids(eligible, max_candidates)


def _match_candidates(cfg, K, mstate, R, t, f, ids, cmask, matcher):
    """Project candidate points `ids` at pose (R, t), match them against
    frame `f` and scatter the accepted point ids onto its keypoint rows."""
    N = f.kpts.shape[0]
    idx = ids.long()
    uv, _, front = projection.project(K, R, t, mstate.pts_xyz[idx])
    vis = cmask & front & projection.in_image(
        uv, cfg.frontend.image_height, cfg.frontend.image_width)
    desc = mstate.pts_desc[idx].to(f.desc.dtype)
    if matcher is None:
        m = match_ops.mutual_nn_match(desc, vis, f.desc, f.valid)
    else:
        m = matcher(uv, desc, vis, f.kpts, f.desc, f.valid)
    good = match_ops.score_filter(m.matches0, m.mscores0,
                                  cfg.frontend.map_match_threshold)
    cur_rows = torch.where(good, m.matches0, N)
    reobs = _scatter(torch.full((N,), -1, dtype=_I32, device=f.kpts.device),
                     cur_rows, torch.where(good, ids, -1))
    return ReobserveResult(reobs_mpid=reobs,
                           num_candidates=vis.to(_I32).sum(dtype=_I32))


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
    Kmax = mstate.capacity_kf
    Pmax = mstate.capacity_pts
    dev = seed_mpid.device
    obs_kf = mstate.pts_obs_kf[torch.clamp(seed_mpid, 0, Pmax - 1).long()]
    ok = (seed_mpid >= 0)[:, None] & (obs_kf >= 0)
    ids = torch.where(ok, obs_kf, Kmax).reshape(-1)
    hist = _scatter(torch.zeros(Kmax, dtype=_I32, device=dev), ids,
                    torch.ones_like(ids), accumulate=True)
    w1, k1 = select_ops.topk_stable(hist, cfg.map.covis_k1)
    k1 = torch.where(w1 > 0, k1, -1)
    k1c = torch.clamp(k1, 0, Kmax - 1)
    nbr = mstate.covis_nbr[k1c]                                  # (K1, C)
    nbr_w = torch.where((k1[:, None] >= 0) & (nbr >= 0),
                        mstate.covis_w[k1c], -1)
    top_w, top_i = select_ops.topk_stable(nbr_w, cfg.map.covis_top_neighbors)
    cand_kf = torch.gather(nbr, 1, top_i).reshape(-1)
    k2_w, k2_i = select_ops.topk_stable(top_w.reshape(-1), cfg.map.covis_k2)
    k2 = torch.where(k2_w > 0, cand_kf[k2_i], -1)
    kf_union = torch.cat([k1.to(_I32), k2.to(_I32)])
    rows = mstate.kf_kp2mp[torch.clamp(kf_union, 0, Kmax - 1).long()]
    flat = torch.where((kf_union >= 0)[:, None], rows, -1).reshape(-1)
    return _scatter(torch.zeros(Pmax, dtype=torch.bool, device=dev),
                    torch.where(flat >= 0, flat, Pmax), True)


def match_covisible(cfg: SLAMConfig, K, mstate: MapState, R_pred, t_pred, f,
                    seed_mpid, already_mpid, matcher=None) -> ReobserveResult:
    """Covisibility retrieval: the expansion of the currently matched
    points, minus points already matched this frame, projected at the
    predicted pose and matched against the current frame."""
    Pmax = mstate.capacity_pts
    member = _covis_member(cfg, mstate, seed_mpid)
    member = _scatter(member, torch.where(already_mpid >= 0, already_mpid,
                                          Pmax), False)
    eligible = member & mstate.pts_valid & ~mstate.pts_bad
    cand, cmask = select_ops.select_newest_ids(eligible,
                                               cfg.map.covis_max_points)
    return _match_candidates(cfg, K, mstate, R_pred, t_pred, f, cand, cmask,
                             matcher)
