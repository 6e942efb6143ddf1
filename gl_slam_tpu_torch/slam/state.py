"""Fixed-capacity map state (structure of arrays) + keyframe insertion.

Counterpart of gl_slam_tpu/slam/state.py: keyframes, map points,
observation rings, the top-C covisibility adjacency and the loop-closure
keyframe database as preallocated tensors with counts and masks.

The JAX scatters use `.at[...].set(..., mode='drop')`, which drops
out-of-range indices; every caller there sends "drop" to exactly one index
past the end (the capacity). `_scatter` reproduces that with one spare row
appended before the write and sliced off after it, never by clamping (a
clamped write would land on a real row). Reads with index -1 keep Python's
wrap-around, as in JAX. Slot recycling (`recycle_free_slots`) comes with
window BA in a later part of the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.select import topk_stable

_I32 = torch.int32


class MapState(NamedTuple):
    # Keyframes
    num_kf: torch.Tensor        # () int32
    kf_R: torch.Tensor          # (Kmax,3,3) world->camera
    kf_t: torch.Tensor          # (Kmax,3)
    kf_kpts: torch.Tensor       # (Kmax,N,2)
    kf_kp2mp: torch.Tensor      # (Kmax,N) int32 map-point id per keypoint
    kf_kp_valid: torch.Tensor   # (Kmax,N) bool
    kf_frame_idx: torch.Tensor  # (Kmax,) int32
    # Map points
    num_pts: torch.Tensor       # () int32
    pts_xyz: torch.Tensor       # (Pmax,3)
    pts_desc: torch.Tensor      # (Pmax,D) latest observed descriptor
    pts_valid: torch.Tensor     # (Pmax,) bool
    pts_bad: torch.Tensor       # (Pmax,) bool
    pts_obs_kf: torch.Tensor    # (Pmax,O) int32 ring of observing keyframes
    pts_obs_kp: torch.Tensor    # (Pmax,O) int32 keypoint index there
    pts_obs_cnt: torch.Tensor   # (Pmax,) int32
    pts_first_kf: torch.Tensor  # (Pmax,) int32
    pts_last_kf: torch.Tensor   # (Pmax,) int32
    # Covisibility top-C adjacency
    covis_nbr: torch.Tensor     # (Kmax,C) int32
    covis_w: torch.Tensor       # (Kmax,C) int32
    # Keyframe feature database (loop-closure detection)
    kf_db_idx: torch.Tensor     # (Kmax,Kdb) int32
    kf_db_desc: torch.Tensor    # (Kmax,Kdb,D)
    kf_db_xyz: torch.Tensor     # (Kmax,Kdb,3)
    kf_db_valid: torch.Tensor   # (Kmax,Kdb) bool
    # Slot recycling free list
    free_stack: torch.Tensor    # (Pmax,) int32
    free_count: torch.Tensor    # () int32
    pts_freed: torch.Tensor     # (Pmax,) bool

    @property
    def capacity_kf(self) -> int:
        return self.kf_R.shape[0]

    @property
    def capacity_pts(self) -> int:
        return self.pts_xyz.shape[0]


def _scatter(x: torch.Tensor, idx: torch.Tensor, vals, flat: bool = False,
             accumulate: bool = False) -> torch.Tensor:
    """`x.at[idx].set(vals, mode='drop')` (or `.add` with `accumulate`) for
    row indices in [0, len(x)], len(x) being dropped. With `flat`, `idx`
    indexes x viewed as 1-D and may run up to the end of one spare row."""
    spare = torch.zeros((1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    buf = torch.cat([x, spare])
    view = buf.view(-1) if flat else buf
    vals = torch.as_tensor(vals, dtype=x.dtype, device=x.device)
    if accumulate:
        view.index_add_(0, idx.long(), vals.expand(idx.shape + x.shape[1:]))
    else:
        view.index_put_((idx.long(),), vals)
    return buf[:-1]


def init_map_state(max_keyframes: int, max_points: int, max_kpts: int,
                   desc_dim: int, max_obs: int = 16, max_covis: int = 32,
                   desc_dtype=torch.bfloat16, loop_db: int = 256,
                   device=None) -> MapState:
    f32 = torch.float32
    kw = dict(device=device)
    return MapState(
        num_kf=torch.zeros((), dtype=_I32, **kw),
        kf_R=torch.eye(3, dtype=f32, **kw).repeat(max_keyframes, 1, 1),
        kf_t=torch.zeros((max_keyframes, 3), dtype=f32, **kw),
        kf_kpts=torch.zeros((max_keyframes, max_kpts, 2), dtype=f32, **kw),
        kf_kp2mp=torch.full((max_keyframes, max_kpts), -1, dtype=_I32, **kw),
        kf_kp_valid=torch.zeros((max_keyframes, max_kpts), dtype=torch.bool,
                                **kw),
        kf_frame_idx=torch.full((max_keyframes,), -1, dtype=_I32, **kw),
        num_pts=torch.zeros((), dtype=_I32, **kw),
        pts_xyz=torch.zeros((max_points, 3), dtype=f32, **kw),
        pts_desc=torch.zeros((max_points, desc_dim), dtype=desc_dtype, **kw),
        pts_valid=torch.zeros((max_points,), dtype=torch.bool, **kw),
        pts_bad=torch.zeros((max_points,), dtype=torch.bool, **kw),
        pts_obs_kf=torch.full((max_points, max_obs), -1, dtype=_I32, **kw),
        pts_obs_kp=torch.full((max_points, max_obs), -1, dtype=_I32, **kw),
        pts_obs_cnt=torch.zeros((max_points,), dtype=_I32, **kw),
        pts_first_kf=torch.full((max_points,), -1, dtype=_I32, **kw),
        pts_last_kf=torch.full((max_points,), -1, dtype=_I32, **kw),
        covis_nbr=torch.full((max_keyframes, max_covis), -1, dtype=_I32,
                             **kw),
        covis_w=torch.zeros((max_keyframes, max_covis), dtype=_I32, **kw),
        kf_db_idx=torch.full((max_keyframes, loop_db), -1, dtype=_I32, **kw),
        kf_db_desc=torch.zeros((max_keyframes, loop_db, desc_dim),
                               dtype=desc_dtype, **kw),
        kf_db_xyz=torch.zeros((max_keyframes, loop_db, 3), dtype=f32, **kw),
        kf_db_valid=torch.zeros((max_keyframes, loop_db), dtype=torch.bool,
                                **kw),
        free_stack=torch.full((max_points,), -1, dtype=_I32, **kw),
        free_count=torch.zeros((), dtype=_I32, **kw),
        pts_freed=torch.zeros((max_points,), dtype=torch.bool, **kw),
    )


def insert_keyframe(state: MapState, R, t, frame_idx, kpts, desc, kp_valid,
                    reobs_mpid, new_xyz, new_valid, new_kp_cur, new_kp_prev,
                    prev_kf, covis_threshold: int = 50,
                    enabled: Optional[torch.Tensor] = None) -> MapState:
    """Register a keyframe, create map points from triangulated leftovers
    (observed at `new_kp_prev[j]` in keyframe `prev_kf` and `new_kp_cur[j]`
    here), append re-observations `reobs_mpid` (N,) of existing points and
    update the covisibility graph. With `enabled` False the insert is a
    no-op: every write goes to the dropped index and no counter advances."""
    dev = kpts.device
    k = state.num_kf
    N = kpts.shape[0]
    Pmax = state.capacity_pts
    Kmax = state.capacity_kf
    O = state.pts_obs_kf.shape[1]
    C = state.covis_nbr.shape[1]
    ar = torch.arange(N, dtype=_I32, device=dev)
    prev_kf = torch.as_tensor(prev_kf, dtype=_I32, device=dev)

    en = torch.ones((), dtype=torch.bool, device=dev) if enabled is None \
        else enabled
    en = en & (k < Kmax)
    k_w = torch.where(en, k, Kmax)

    # (1) keyframe registration
    kf_R = _scatter(state.kf_R, k_w, R)
    kf_t = _scatter(state.kf_t, k_w, t)
    kf_kpts = _scatter(state.kf_kpts, k_w, kpts)
    kf_kp_valid = _scatter(state.kf_kp_valid, k_w, kp_valid)
    kf_frame_idx = _scatter(state.kf_frame_idx, k_w,
                            torch.as_tensor(frame_idx, dtype=_I32,
                                            device=dev))

    # (2) new map points: pop the free stack first, then fresh slots
    nv = new_valid & (new_kp_cur >= 0) & en
    offsets = torch.cumsum(nv.to(_I32), 0, dtype=_I32) - 1
    avail = state.free_count
    use_free = nv & (offsets < avail)
    free_idx = torch.clamp(avail - 1 - offsets, 0, Pmax - 1)
    pid = torch.where(use_free, state.free_stack[free_idx.long()],
                      torch.clamp(state.num_pts + offsets - avail, 0, Pmax))
    pid_w = torch.where(nv & (pid < Pmax), pid, Pmax)
    n_new = nv.to(_I32).sum(dtype=_I32)
    n_from_free = torch.minimum(n_new, avail)

    has_reobs = (reobs_mpid >= 0) & kp_valid & en
    rp = torch.where(has_reobs, reobs_mpid, Pmax)
    col = state.pts_obs_cnt[torch.clamp(rp, 0, Pmax - 1).long()]
    slot = col % O

    desc_new = desc[torch.clamp(new_kp_cur, 0, N - 1).long()]
    pts_xyz = _scatter(state.pts_xyz, pid_w, new_xyz)
    pts_valid = _scatter(state.pts_valid, pid_w, True)
    pts_bad = _scatter(state.pts_bad, pid_w, False)
    pts_freed = _scatter(state.pts_freed, pid_w, False)
    pts_first_kf = _scatter(state.pts_first_kf, pid_w, k)
    pts_desc = _scatter(state.pts_desc,
                        torch.cat([pid_w, torch.clamp(rp, 0, Pmax)]),
                        torch.cat([desc_new, desc]))
    pts_last_kf = _scatter(state.pts_last_kf, torch.cat([pid_w, rp]), k)
    obs_idx = torch.cat([pid_w * O, pid_w * O + 1, rp * O + slot])
    pts_obs_kf = _scatter(state.pts_obs_kf, obs_idx, torch.cat(
        [prev_kf.expand(N), k.expand(2 * N)]), flat=True)
    pts_obs_kp = _scatter(state.pts_obs_kp, obs_idx, torch.cat(
        [new_kp_prev.to(_I32), new_kp_cur.to(_I32), ar]), flat=True)
    pts_obs_cnt = _scatter(state.pts_obs_cnt, pid_w, 2)
    pts_obs_cnt = _scatter(pts_obs_cnt, rp, torch.ones_like(rp),
                           accumulate=True)

    # kp -> mpid index for the new keyframe and the spawning prev keyframe
    kp2mp_row = torch.where(has_reobs, reobs_mpid, -1).to(_I32)
    new_kp_w = torch.where(nv & (pid < Pmax), new_kp_cur, N)
    kp2mp_row = _scatter(kp2mp_row, new_kp_w, torch.where(nv, pid, -1))
    kf_kp2mp = _scatter(state.kf_kp2mp, k_w, kp2mp_row)
    prev_c = torch.clamp(prev_kf, 0, Kmax - 1).long()
    new_kp_prev_w = torch.where(nv & (pid < Pmax), new_kp_prev, N)
    prev_row = _scatter(state.kf_kp2mp[prev_c], new_kp_prev_w,
                        torch.where(nv, pid, -1))
    kf_kp2mp = kf_kp2mp.index_put((prev_c,), prev_row)

    # keyframe feature database: the first Kdb keypoints with 3D
    Kdb = state.kf_db_idx.shape[1]
    has3d = (kp2mp_row >= 0) & kp_valid
    top_db, _ = topk_stable(torch.where(has3d, N - ar, -1), Kdb)
    db_idx = torch.where(top_db >= 0, N - top_db, -1).to(_I32)
    db_rows = torch.clamp(db_idx, 0, N - 1).long()
    db_mp = torch.clamp(kp2mp_row[db_rows], 0, Pmax - 1).long()
    kf_db_idx = _scatter(state.kf_db_idx, k_w, db_idx)
    kf_db_desc = _scatter(state.kf_db_desc, k_w, desc[db_rows])
    kf_db_xyz = _scatter(state.kf_db_xyz, k_w, pts_xyz[db_mp])
    kf_db_valid = _scatter(state.kf_db_valid, k_w, db_idx >= 0)

    # (4) covisibility: shared-observation counts with every other keyframe
    matched_p = torch.where(has_reobs, reobs_mpid, Pmax - 1)
    obs_rows_kf = pts_obs_kf[torch.clamp(matched_p, 0, Pmax - 1).long()]
    obs_valid = (obs_rows_kf >= 0) & (obs_rows_kf != k) & has_reobs[:, None]
    ids = torch.where(obs_valid, obs_rows_kf, Kmax).reshape(-1)
    counts = _scatter(torch.zeros(Kmax, dtype=_I32, device=dev), ids,
                      torch.ones_like(ids), accumulate=True)
    w_top, nbr_top = topk_stable(counts, C)
    edge_ok = (w_top >= covis_threshold) & en
    nbr_row = torch.where(edge_ok, nbr_top.to(_I32), -1)
    w_row = torch.where(edge_ok, w_top, 0)
    covis_nbr = _scatter(state.covis_nbr, k_w, nbr_row)
    covis_w = _scatter(state.covis_w, k_w, w_row)
    # Reverse edges: (k, w) into each neighbour's weakest slot.
    nbr_c = torch.clamp(nbr_row, 0, Kmax - 1).long()
    slot_w = torch.where(covis_nbr[nbr_c] >= 0, covis_w[nbr_c], -1)
    weakest = torch.argmin(slot_w, dim=1)
    can = edge_ok & (w_row > slot_w.amin(dim=1))
    tgt = torch.where(can, nbr_row, Kmax).long() * C + weakest
    covis_w = _scatter(covis_w, tgt, w_row, flat=True)
    covis_nbr = _scatter(covis_nbr, tgt, k.expand(C), flat=True)

    return state._replace(
        num_kf=k + en.to(_I32),
        kf_R=kf_R, kf_t=kf_t, kf_kpts=kf_kpts, kf_kp2mp=kf_kp2mp,
        kf_kp_valid=kf_kp_valid, kf_frame_idx=kf_frame_idx,
        num_pts=torch.clamp(state.num_pts + n_new - n_from_free, max=Pmax),
        pts_xyz=pts_xyz, pts_desc=pts_desc, pts_valid=pts_valid,
        pts_bad=pts_bad, pts_obs_kf=pts_obs_kf, pts_obs_kp=pts_obs_kp,
        pts_obs_cnt=pts_obs_cnt, pts_first_kf=pts_first_kf,
        pts_last_kf=pts_last_kf, covis_nbr=covis_nbr, covis_w=covis_w,
        kf_db_idx=kf_db_idx, kf_db_desc=kf_db_desc, kf_db_xyz=kf_db_xyz,
        kf_db_valid=kf_db_valid, free_count=avail - n_from_free,
        pts_freed=pts_freed)
