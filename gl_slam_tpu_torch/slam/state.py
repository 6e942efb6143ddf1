"""Fixed-capacity map state (structure of arrays) + keyframe insertion.

Counterpart of gl_slam_tpu/slam/state.py: keyframes, map points,
observation rings, the top-C covisibility adjacency and the loop-closure
keyframe database as preallocated tensors with counts and masks.

The JAX scatters use `.at[...].set(..., mode='drop')`, which drops
out-of-range indices; every caller there sends "drop" to exactly one index
past the end (the capacity). `_scatter` reproduces that with one spare row
appended before the write and sliced off after it, never by clamping (a
clamped write would land on a real row). Reads with index -1 keep Python's
wrap-around, as in JAX.

A state may carry a leading stream axis (`init_map_state(...,
num_streams=S)`): every field gains a first dimension of S, the counters
(`num_kf`, `num_pts`, `free_count`) become (S,) and every function here
works per stream. `_gather`, `_at` and `_scatter` take the number of
leading axes (`lead`, the rank of `num_kf`) and offset each stream's row
indices by its own table, so no read or write crosses streams; a state
without the axis runs the same code with `lead=0`, unchanged. This is the
counterpart of `jax.vmap` over the stream axis in the JAX package's
multi-stream tracker.

Every update builds new tensors (`_scatter` copies before it writes) and
nothing mutates a state tensor in place, so an older `MapState` stays valid
after later updates: ChunkedPipeline's health-check snapshots alias the live
state instead of copying it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
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
    def lead(self) -> int:
        """Number of leading (stream) axes: 0, or 1 under a stream axis."""
        return self.num_kf.dim()

    @property
    def capacity_kf(self) -> int:
        return self.kf_R.shape[-3]

    @property
    def capacity_pts(self) -> int:
        return self.pts_xyz.shape[-2]


def tree_map(fn, tree):
    """Apply `fn` to every tensor of a (nested) named tuple of tensors,
    keeping None fields as they are."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    return fn(tree)


def stack_streams(tree, num_streams: int):
    """A named tuple of tensors repeated along a new leading stream axis of
    `num_streams` (each stream its own copy)."""
    return tree_map(lambda x: x.expand(num_streams, *x.shape).clone(), tree)


def _bc(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-stream flag or scalar x (*B,) shaped to broadcast against
    `like` (*B, ...); a 0-d x is returned as it is."""
    if x.dim() == 0:
        return x
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def _where(c: torch.Tensor, a: torch.Tensor, b) -> torch.Tensor:
    """torch.where with a per-stream condition broadcast against `a`."""
    return torch.where(_bc(c, a), a, b)


def _offsets(x: torch.Tensor, lead: int, rows: int, nd: int) -> torch.Tensor:
    """The first flat row of each leading entry of `x` (its first `lead`
    axes flattened, `rows` rows each), shaped to broadcast against an
    index of `nd` dims whose first `lead` dims are those axes."""
    shape = x.shape[:lead]
    off = torch.arange(math.prod(shape), dtype=torch.long, device=x.device)
    return (off * rows).reshape(shape + (1,) * (nd - lead))


def _gather(x: torch.Tensor, idx: torch.Tensor, lead: int = 0
            ) -> torch.Tensor:
    """x[idx] per leading entry: x (*B, R, *rest), idx (*B, *I) ->
    (*B, *I, *rest), each entry reading only its own R rows (-1 wraps to
    its own last row, as in JAX). `lead=0` is plain `x[idx]`."""
    if lead == 0:
        return x[idx.long()]
    R = x.shape[lead]
    flat = x.reshape((-1,) + x.shape[lead + 1:])
    return flat[idx.long() % R + _offsets(x, lead, R, idx.dim())]


def _at(x: torch.Tensor, i: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """x[i] for a 0-d index tensor on the device (or, with `lead`, one
    index per leading entry: i (*B,) -> (*B, *rest)). Plain indexing turns
    a 0-d index into a Python int, a read that waits for the stream."""
    if lead:
        return _gather(x, i, lead)
    return x.index_select(0, i.reshape(1))[0]


def _scatter(x: torch.Tensor, idx: torch.Tensor, vals, flat: bool = False,
             accumulate: bool = False, lead: int = 0) -> torch.Tensor:
    """`x.at[idx].set(vals, mode='drop')` (or `.add` with `accumulate`) for
    row indices in [0, len(x)], len(x) being dropped. With `flat`, `idx`
    indexes x viewed as 1-D and may run up to the end of one spare row.
    A Python scalar `vals` is written by a fill, not turned into a device
    tensor first: that copy would make the host wait for the stream.

    With `lead` leading axes, x is (*B, R, *rest), idx (*B, *I) and vals
    broadcasts to (*B, *I, *rest): each leading entry writes its own rows
    (and drops at its own spare row)."""
    if lead:
        return _scatter_lead(x, idx, vals, flat, accumulate, lead)
    spare = torch.zeros((1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    buf = torch.cat([x, spare])
    view = buf.view(-1) if flat else buf
    if not torch.is_tensor(vals):
        view.index_fill_(0, idx.reshape(-1).long(), vals)
    elif accumulate:
        view.index_add_(0, idx.long(), vals.to(x.dtype).expand(
            idx.shape + x.shape[1:]))
    else:
        view.index_put_((idx.long(),), vals.to(x.dtype))
    return buf[:-1]


def _scatter_lead(x, idx, vals, flat, accumulate, lead):
    B, R, rest = x.shape[:lead], x.shape[lead], x.shape[lead + 1:]
    spare = torch.zeros(B + (1,) + rest, dtype=x.dtype, device=x.device)
    buf = torch.cat([x, spare], dim=lead)
    if flat:
        per, row = (R + 1) * math.prod(rest), ()
    else:
        per, row = R + 1, rest
    view = buf.view((-1,) + row)
    gi = (idx.long() + _offsets(x, lead, per, idx.dim())).reshape(-1)
    if not torch.is_tensor(vals):
        view.index_fill_(0, gi, vals)
    else:
        v = torch.broadcast_to(vals.to(x.dtype), idx.shape + row).reshape(
            (-1,) + row)
        if accumulate:
            view.index_add_(0, gi, v)
        else:
            view.index_put_((gi,), v)
    return buf.narrow(lead, 0, R)


def init_map_state(max_keyframes: int, max_points: int, max_kpts: int,
                   desc_dim: int, max_obs: int = 16, max_covis: int = 32,
                   desc_dtype=torch.bfloat16, loop_db: int = 256,
                   device=None, num_streams: Optional[int] = None
                   ) -> MapState:
    """An empty map; with `num_streams` S, S empty maps on a leading
    stream axis."""
    f32 = torch.float32
    kw = dict(device=device)
    m = MapState(
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
    return m if num_streams is None else stack_streams(m, num_streams)


def insert_keyframe(state: MapState, R, t, frame_idx, kpts, desc, kp_valid,
                    reobs_mpid, new_xyz, new_valid, new_kp_cur, new_kp_prev,
                    prev_kf, covis_threshold: int = 50,
                    enabled: Optional[torch.Tensor] = None) -> MapState:
    """Register a keyframe, create map points from triangulated leftovers
    (observed at `new_kp_prev[j]` in keyframe `prev_kf` and `new_kp_cur[j]`
    here), append re-observations `reobs_mpid` (N,) of existing points and
    update the covisibility graph. With `enabled` False the insert is a
    no-op: every write goes to the dropped index and no counter advances.
    Under a stream axis every argument carries it too (`prev_kf`,
    `frame_idx` and `enabled` one per stream)."""
    L = state.lead
    dev = kpts.device
    k = state.num_kf
    B = k.shape
    N = kpts.shape[-2]
    Pmax = state.capacity_pts
    Kmax = state.capacity_kf
    O = state.pts_obs_kf.shape[-1]
    C = state.covis_nbr.shape[-1]
    ar = torch.arange(N, dtype=_I32, device=dev)
    prev_kf = torch.as_tensor(prev_kf, dtype=_I32, device=dev)

    def col(x):                     # a per-stream scalar against (..., N)
        return x[..., None]

    en = torch.ones((), dtype=torch.bool, device=dev) if enabled is None \
        else enabled
    en = en & (k < Kmax)
    k_w = torch.where(en, k, Kmax)

    # (1) keyframe registration
    kf_R = _scatter(state.kf_R, k_w, R, lead=L)
    kf_t = _scatter(state.kf_t, k_w, t, lead=L)
    kf_kpts = _scatter(state.kf_kpts, k_w, kpts, lead=L)
    kf_kp_valid = _scatter(state.kf_kp_valid, k_w, kp_valid, lead=L)
    kf_frame_idx = _scatter(state.kf_frame_idx, k_w,
                            torch.as_tensor(frame_idx, dtype=_I32,
                                            device=dev), lead=L)

    # (2) new map points: pop the free stack first, then fresh slots
    nv = new_valid & (new_kp_cur >= 0) & col(en)
    offsets = torch.cumsum(nv.to(_I32), -1, dtype=_I32) - 1
    avail = state.free_count
    use_free = nv & (offsets < col(avail))
    free_idx = torch.clamp(col(avail) - 1 - offsets, 0, Pmax - 1)
    pid = torch.where(use_free, _gather(state.free_stack, free_idx, L),
                      torch.clamp(col(state.num_pts) + offsets - col(avail),
                                  0, Pmax))
    pid_w = torch.where(nv & (pid < Pmax), pid, Pmax)
    n_new = nv.to(_I32).sum(-1, dtype=_I32)
    n_from_free = torch.minimum(n_new, avail)

    has_reobs = (reobs_mpid >= 0) & kp_valid & col(en)
    rp = torch.where(has_reobs, reobs_mpid, Pmax)
    cnt = _gather(state.pts_obs_cnt, torch.clamp(rp, 0, Pmax - 1), L)
    slot = cnt % O

    desc_new = _gather(desc, torch.clamp(new_kp_cur, 0, N - 1), L)
    pts_xyz = _scatter(state.pts_xyz, pid_w, new_xyz, lead=L)
    pts_valid = _scatter(state.pts_valid, pid_w, True, lead=L)
    pts_bad = _scatter(state.pts_bad, pid_w, False, lead=L)
    pts_freed = _scatter(state.pts_freed, pid_w, False, lead=L)
    pts_first_kf = _scatter(state.pts_first_kf, pid_w, col(k), lead=L)
    pts_desc = _scatter(state.pts_desc,
                        torch.cat([pid_w, torch.clamp(rp, 0, Pmax)], -1),
                        torch.cat([desc_new, desc], -2), lead=L)
    pts_last_kf = _scatter(state.pts_last_kf, torch.cat([pid_w, rp], -1),
                           col(k), lead=L)
    obs_idx = torch.cat([pid_w * O, pid_w * O + 1, rp * O + slot], -1)
    pts_obs_kf = _scatter(state.pts_obs_kf, obs_idx, torch.cat(
        [col(prev_kf).expand(B + (N,)), col(k).expand(B + (2 * N,))], -1),
        flat=True, lead=L)
    pts_obs_kp = _scatter(state.pts_obs_kp, obs_idx, torch.cat(
        [new_kp_prev.to(_I32), new_kp_cur.to(_I32), ar.expand(B + (N,))],
        -1), flat=True, lead=L)
    pts_obs_cnt = _scatter(state.pts_obs_cnt, pid_w, 2, lead=L)
    pts_obs_cnt = _scatter(pts_obs_cnt, rp, torch.ones_like(rp),
                           accumulate=True, lead=L)

    # kp -> mpid index for the new keyframe and the spawning prev keyframe
    kp2mp_row = torch.where(has_reobs, reobs_mpid, -1).to(_I32)
    new_kp_w = torch.where(nv & (pid < Pmax), new_kp_cur, N)
    kp2mp_row = _scatter(kp2mp_row, new_kp_w, torch.where(nv, pid, -1),
                         lead=L)
    kf_kp2mp = _scatter(state.kf_kp2mp, k_w, kp2mp_row, lead=L)
    prev_c = torch.clamp(prev_kf, 0, Kmax - 1).long()
    new_kp_prev_w = torch.where(nv & (pid < Pmax), new_kp_prev, N)
    prev_row = _scatter(_at(state.kf_kp2mp, prev_c, L), new_kp_prev_w,
                        torch.where(nv, pid, -1), lead=L)
    kf_kp2mp = _scatter(kf_kp2mp, prev_c, prev_row, lead=L) if L \
        else kf_kp2mp.index_put((prev_c,), prev_row)

    # keyframe feature database: the first Kdb keypoints with 3D
    Kdb = state.kf_db_idx.shape[-1]
    has3d = (kp2mp_row >= 0) & kp_valid
    top_db, _ = topk_stable(torch.where(has3d, N - ar, -1), Kdb)
    db_idx = torch.where(top_db >= 0, N - top_db, -1).to(_I32)
    db_rows = torch.clamp(db_idx, 0, N - 1)
    db_mp = torch.clamp(_gather(kp2mp_row, db_rows, L), 0, Pmax - 1)
    kf_db_idx = _scatter(state.kf_db_idx, k_w, db_idx, lead=L)
    kf_db_desc = _scatter(state.kf_db_desc, k_w, _gather(desc, db_rows, L),
                          lead=L)
    kf_db_xyz = _scatter(state.kf_db_xyz, k_w, _gather(pts_xyz, db_mp, L),
                         lead=L)
    kf_db_valid = _scatter(state.kf_db_valid, k_w, db_idx >= 0, lead=L)

    # (4) covisibility: shared-observation counts with every other keyframe
    matched_p = torch.where(has_reobs, reobs_mpid, Pmax - 1)
    obs_rows_kf = _gather(pts_obs_kf, torch.clamp(matched_p, 0, Pmax - 1), L)
    obs_valid = (obs_rows_kf >= 0) & (obs_rows_kf != k[..., None, None]) \
        & has_reobs[..., None]
    ids = torch.where(obs_valid, obs_rows_kf, Kmax).reshape(B + (-1,))
    counts = _scatter(torch.zeros(B + (Kmax,), dtype=_I32, device=dev), ids,
                      torch.ones_like(ids), accumulate=True, lead=L)
    w_top, nbr_top = topk_stable(counts, C)
    edge_ok = (w_top >= covis_threshold) & col(en)
    nbr_row = torch.where(edge_ok, nbr_top.to(_I32), -1)
    w_row = torch.where(edge_ok, w_top, 0)
    covis_nbr = _scatter(state.covis_nbr, k_w, nbr_row, lead=L)
    covis_w = _scatter(state.covis_w, k_w, w_row, lead=L)
    # Reverse edges: (k, w) into each neighbour's weakest slot.
    nbr_c = torch.clamp(nbr_row, 0, Kmax - 1)
    slot_w = torch.where(_gather(covis_nbr, nbr_c, L) >= 0,
                         _gather(covis_w, nbr_c, L), -1)
    weakest = torch.argmin(slot_w, dim=-1)
    can = edge_ok & (w_row > slot_w.amin(dim=-1))
    tgt = torch.where(can, nbr_row, Kmax).long() * C + weakest
    covis_w = _scatter(covis_w, tgt, w_row, flat=True, lead=L)
    covis_nbr = _scatter(covis_nbr, tgt, col(k).expand(B + (C,)), flat=True,
                         lead=L)

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


def recycle_free_slots(state: MapState, min_age: int, budget: int,
                       stale_age: int = 0) -> MapState:
    """Push up to `budget` culled point slots onto the free stack.

    Eligible slots hold culled (`pts_bad`) points not observed for
    `min_age` keyframes: old enough that no window BA, re-observation pass
    or BA snapshot can still reference them. Freed slots are invalidated and
    their observation rows cleared, so every read path skips them.

    `stale_age` > 0 adds eviction under pressure: when fewer than
    2 x budget slots are available (fresh + stack), healthy points not
    observed for `stale_age` keyframes become eligible too; well-observed
    ones (the archive loop closing matches against) only once the archive
    exceeds half the table.

    Priority: culled slots first, then never-corroborated stale points
    (obs_cnt < 3) oldest first, then archive points fewest-observations
    first. The priorities are full of ties (-1 for every non-candidate,
    equal ages) and which slots are freed decides the ids of every later
    map point, so the ranking is `topk_stable` (ties to the lower index,
    like `lax.top_k`). Works per stream under a stream axis."""
    L = state.lead
    Pmax = state.capacity_pts
    dev = state.pts_xyz.device
    budget = min(budget, Pmax)
    age = state.num_kf[..., None] - state.pts_last_kf
    old = age > min_age
    bad_cand = state.pts_valid & state.pts_bad & ~state.pts_freed & old
    cand = bad_cand
    low_obs = state.pts_obs_cnt < 3
    if stale_age > 0:
        available = (Pmax - state.num_pts) + state.free_count
        pressure = (available < 2 * budget)[..., None]
        stale = state.pts_valid & ~state.pts_freed & (age > stale_age)
        n_archive = (state.pts_valid & ~state.pts_bad & ~low_obs).to(
            _I32).sum(-1, dtype=_I32)
        archive_over = (n_archive > Pmax // 2)[..., None]
        cand = cand | (stale & pressure & (low_obs | archive_over))
    obs_rank = 64 - torch.clamp(state.pts_obs_cnt, 0, 64)   # fewest -> high
    prio = torch.where(
        cand,
        torch.where(bad_cand, (1 << 24) + torch.clamp(age, 0, 1 << 18),
                    torch.where(low_obs,
                                (1 << 20) + torch.clamp(age, 0, 1 << 18),
                                obs_rank * (1 << 12)
                                + torch.clamp(age, 0, (1 << 12) - 1))), -1)
    _, ids = topk_stable(prio, budget)
    ids = ids.to(_I32)
    ar = torch.arange(budget, dtype=_I32, device=dev)
    # Stack-capacity guard (each slot appears at most once on the stack)
    fc = state.free_count[..., None]
    ok = _gather(cand, ids, L) & (fc + ar < Pmax)
    n = ok.to(_I32).sum(-1, dtype=_I32)
    # Unique indices: top-k positions are distinct, the rest are dropped.
    tgt = torch.where(ok, ids, Pmax)
    pos = torch.where(ok, fc + ar, Pmax)
    return state._replace(
        pts_valid=_scatter(state.pts_valid, tgt, False, lead=L),
        pts_freed=_scatter(state.pts_freed, tgt, True, lead=L),
        pts_obs_kf=_scatter(state.pts_obs_kf, tgt, -1, lead=L),
        pts_obs_kp=_scatter(state.pts_obs_kp, tgt, -1, lead=L),
        pts_obs_cnt=_scatter(state.pts_obs_cnt, tgt, 0, lead=L),
        pts_first_kf=_scatter(state.pts_first_kf, tgt, -1, lead=L),
        pts_last_kf=_scatter(state.pts_last_kf, tgt, -1, lead=L),
        free_stack=_scatter(state.free_stack, pos, ids, lead=L),
        free_count=state.free_count + n)


def map_state_from_numpy(fields, device=None) -> MapState:
    """Build a `MapState` from numpy arrays: `fields` is a mapping or a
    named tuple with the `MapState` field names (for example the JAX
    package's map state converted with `np.asarray`). Integer fields become
    int32, float fields float32; bfloat16 arrays (descriptor tables) are
    carried across exactly through float32."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    out = {}
    for name in MapState._fields:
        a = np.asarray(fields[name])
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        elif a.dtype == np.bool_:
            t = torch.from_numpy(a.copy())
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.from_numpy(a.astype(np.int32))
        else:
            t = torch.from_numpy(a.astype(np.float32))
        out[name] = t.to(device)
    return MapState(**out)
