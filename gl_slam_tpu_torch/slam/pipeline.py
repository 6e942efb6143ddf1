"""Host-side per-frame SLAM pipeline: one tracking step per frame.

Counterpart of gl_slam_tpu/slam/pipeline.py. Each `step` runs
`frontend.track_step` on one frame's features (matching against the
previous keyframe, the essential or PnP RANSAC, the re-observation passes,
the pose solve and the keyframe insert), then the backend on its cadence:
every `ba_trigger_keyframes` frames the health check reads the pose, and
when as many new keyframes have come a sliding-window BA pass runs. With
`runtime.async_ba` the pass's result is folded into the live state one
step later (`ba.reconcile_async_ba`, at the start of the next `step`, in
`trajectory` and in `map_stats`), as the JAX package folds a BA that ran
on a snapshot while tracking went on; without it the result replaces the
map at once. Either way the constant-velocity step carry is re-anchored
to the last two BA-refined camera centres and culled slots are recycled.
Loop closing (`runtime.loop_closing`) checks every `loop_check_interval`
steps past `loop_min_gap` and closes a verified loop on the host.

The host reads the device at the same points as the JAX pipeline and
nowhere else: the pose at each BA trigger (health check), the keyframe
and point counts there, and a loop detection's verdict. A frame's step
issues its work and returns device tensors.

Randomness: the essential RANSAC takes (hypotheses, 8) uniform draws,
one set for the bootstrap and one per tracked frame, in that order; under
the PnP tracker (`runtime.tracker="pnp"`) a tracked frame takes no
essential draws but one (pnp_hypotheses, max_keypoints) Gumbel set for its
PnP RANSAC, from a stream of its own, so that the essential tracker's
draws are what they are without it; each loop detection takes its PnP
Gumbel draws. By default all three come from `torch.Generator`s seeded
from `seed` (default `cfg.runtime.seed`); `draws`, `pnp_draws` and
`loop_draws`, iterables of arrays or tensors, replace them (a test feeds
the JAX package's own draws through them).
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional

import numpy as np
import torch

from .. import tracing
from ..config import SLAMConfig
from ..device import resolve_device, upload
from . import ba as ba_mod
from . import frontend, loopclose
from .frontend import FrameFeatures, TrackState
from .state import _at, recycle_free_slots


def _ba_step_norm(m) -> torch.Tensor:
    """Distance between the last two BA-refined camera centres, clipped to
    [1e-3, 10]: the constant-velocity step magnitude re-anchored to the map
    (it otherwise compounds through the step-ratio sanity bound)."""
    last = torch.clamp_min(m.num_kf - 1, 0).long()
    prev = torch.clamp_min(m.num_kf - 2, 0).long()
    c_last = -(_at(m.kf_R, last).T @ _at(m.kf_t, last))
    c_prev = -(_at(m.kf_R, prev).T @ _at(m.kf_t, prev))
    return torch.clamp(torch.linalg.vector_norm(c_last - c_prev), 1e-3, 10.0)


class TrackingPipeline:
    """Feeds per-frame features through the tracking and BA steps.

    `matcher`: optional learned matcher closure (kpts0, desc0, valid0,
    kpts1, desc1, valid1) -> MatchResult (`fused.build_matcher`), used for
    the prev<->cur pass and both re-observation passes; None = mutual-NN
    everywhere. `device`: where the state lives (None: the card, raising
    without one)."""

    def __init__(self, cfg: SLAMConfig, K, seed: Optional[int] = None,
                 enable_ba: bool = True, matcher=None, device=None,
                 draws: Optional[Iterable] = None,
                 loop_draws: Optional[Iterable] = None,
                 pnp_draws: Optional[Iterable] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.matcher = matcher
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32,
                                 device=self.device)
        seed = cfg.runtime.seed if seed is None else seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._loop_gen = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self._pnp_gen = torch.Generator(device=self.device).manual_seed(
            seed + 2)
        self._draws = None if draws is None else iter(draws)
        self._loop_draws = None if loop_draws is None else iter(loop_draws)
        self._pnp_draws = None if pnp_draws is None else iter(pnp_draws)
        self.state: TrackState = frontend.init_track_state(
            cfg, device=self.device)
        self.outputs: List[Any] = []
        self.enable_ba = enable_ba and cfg.runtime.run_full_ba
        self._kf_at_last_ba = 2
        self._ba_count = 0
        self._steps_since_check = 0
        # (BA result map, snapshot num_kf, snapshot num_pts) while a BA
        # pass on a snapshot waits to be folded into the live state
        self._inflight_ba = None
        self._last_good: Optional[TrackState] = None
        self.num_recoveries = 0
        self.loop_closures = 0

    # -- inputs --------------------------------------------------------------
    def _draw(self) -> torch.Tensor:
        """The next (hypotheses, 8) RANSAC draw set."""
        if self._draws is not None:
            return upload(next(self._draws), torch.float32, self.device)
        H = self.cfg.geometry.essential_hypotheses
        return torch.rand((H, 8), generator=self._gen, device=self.device)

    def _pnp_gumbel(self) -> torch.Tensor:
        """The next (pnp_hypotheses, max_keypoints) PnP RANSAC draw set."""
        if self._pnp_draws is not None:
            return upload(next(self._pnp_draws), torch.float32, self.device)
        cfg = self.cfg
        return loopclose.pnp_draws(
            self._pnp_gen, (cfg.geometry.pnp_hypotheses,
                            cfg.frontend.max_keypoints), device=self.device)

    def _loop_gumbel(self) -> torch.Tensor:
        """The PnP draws of one loop detection: (loop_candidates,
        hypotheses, database rows) with a learned matcher (keyframe-
        database path), else (4, hypotheses, sampled map points)."""
        if self._loop_draws is not None:
            return upload(next(self._loop_draws), torch.float32,
                          self.device)
        cfg, m = self.cfg, self.state.map
        if self.matcher is not None:
            shape = (cfg.runtime.loop_candidates, cfg.geometry.pnp_hypotheses,
                     m.kf_db_idx.shape[1])
        else:
            Pmax = m.capacity_pts
            stride = max(Pmax // 8192, 1)
            shape = (4, cfg.geometry.pnp_hypotheses,
                     min(len(range(0, Pmax, stride)), 8192))
        return loopclose.pnp_draws(self._loop_gen, shape, device=self.device)

    def _features(self, kpts, desc, scores_or_valid,
                  frame_idx) -> FrameFeatures:
        """Scores (any non-bool dtype) become validity by `> 0`."""
        valid = scores_or_valid
        if valid.dtype not in (bool, np.bool_, torch.bool):
            valid = valid > 0
        return FrameFeatures(
            kpts=upload(kpts, torch.float32, self.device),
            desc=upload(desc, torch.float32, self.device),
            valid=upload(valid, torch.bool, self.device),
            frame_idx=torch.full((), int(frame_idx), dtype=torch.int32,
                                 device=self.device))

    def _match(self, kpts0, desc0, valid0, f: FrameFeatures):
        if self.matcher is None:
            return None
        with tracing.span("track.match"):
            return self.matcher(kpts0, desc0, valid0, f.kpts, f.desc,
                                f.valid)

    # -- lifecycle ------------------------------------------------------------
    @torch.no_grad()
    def bootstrap(self, f0, f1, gt_scale: float = 1.0):
        """Two-view initialization. f*: (kpts, desc, valid, frame_idx)."""
        feats0 = self._features(*f0)
        feats1 = self._features(*f1)
        m = self._match(feats0.kpts, feats0.desc, feats0.valid, feats1)
        self.state, out = frontend.bootstrap_step(
            self.cfg, self.K, self.state, feats0, feats1,
            torch.full((), float(gt_scale), dtype=torch.float32,
                       device=self.device), matches=m, u=self._draw())
        self.outputs.append(out)
        return out

    @torch.no_grad()
    def step(self, kpts, desc, valid, frame_idx):
        """Track one frame. Returns the step's TrackOutputs (device
        tensors) without waiting for the device, unless the frame is a BA
        trigger or a loop check."""
        self._reconcile_ba()
        feats = self._features(kpts, desc, valid, frame_idx)
        st = self.state
        m = self._match(st.prev_kpts, st.prev_desc, st.prev_valid, feats)
        if self.cfg.runtime.tracker == "pnp":
            u, gumbel = None, self._pnp_gumbel()
        else:
            u, gumbel = self._draw(), None
        self.state, out = frontend.track_step(
            self.cfg, self.K, st, feats, u, matches=m, matcher=self.matcher,
            pnp_gumbel=gumbel)
        self.outputs.append(out)
        self._maybe_ba()
        self._maybe_loop_close(feats)
        return out

    def _maybe_loop_close(self, feats: FrameFeatures):
        rt = self.cfg.runtime
        if not rt.loop_closing:
            return
        if len(self.outputs) <= rt.loop_min_gap:
            return
        if len(self.outputs) % rt.loop_check_interval != 0:
            return
        # a learned matcher routes to the keyframe-database path
        det = loopclose.detect_loop(
            self.cfg, self.K, self.state.map, feats, self._loop_gumbel(),
            min_gap=rt.loop_min_gap, matcher=self.matcher,
            R_cur=self.state.R_cur, t_cur=self.state.t_cur)
        if bool(det.ok):
            self.state = loopclose.close_loop(self.cfg, self.K, self.state,
                                              det, rt.pose_graph_window)
            self.loop_closures += 1

    def _maybe_ba(self):
        """Every `ba_trigger_keyframes` steps: the health check, then a BA
        pass over the new keyframes (plus `full_ba_overlap`) when enough
        have come since the last one."""
        if not self.enable_ba:
            return
        self._steps_since_check += 1
        if self._steps_since_check < self.cfg.runtime.ba_trigger_keyframes:
            return
        self._steps_since_check = 0
        if not self._health_check():
            return
        num_kf = int(self.state.map.num_kf)
        if num_kf - self._kf_at_last_ba < self.cfg.runtime.ba_trigger_keyframes:
            return
        first = max(self._kf_at_last_ba - self.cfg.ba.full_ba_overlap, 0)
        with tracing.span("backend.ba"):
            new_map = ba_mod.ba_step(self.cfg, self.K, self.state.map, first,
                                     num_kf - first)
        self._kf_at_last_ba = num_kf
        self._ba_count += 1
        if self.cfg.runtime.async_ba:
            # the pass ran on a snapshot (updates never write in place);
            # its result is folded in at the next step
            self._inflight_ba = (new_map, num_kf,
                                 int(self.state.map.num_pts))
        else:
            last = torch.clamp_min(new_map.num_kf - 1, 0).long()
            self.state = self.state._replace(
                map=new_map, R_cur=_at(new_map.kf_R, last),
                t_cur=_at(new_map.kf_t, last),
                t_rel_norm=_ba_step_norm(new_map))
            self._maybe_recycle()

    def _maybe_recycle(self):
        """Release long-dead culled point slots, on the live map only (never
        on an async snapshot, so the free stack has one writer)."""
        mc = self.cfg.map
        if not mc.recycle_enabled:
            return
        with tracing.span("backend.recycle"):
            self.state = self.state._replace(map=recycle_free_slots(
                self.state.map, mc.recycle_min_age,
                min(mc.recycle_budget, mc.max_points),
                stale_age=mc.recycle_stale_age))

    def _health_check(self) -> bool:
        """A non-finite pose rolls the state back to the last snapshot
        that passed (and drops an in-flight BA). Reads the pose at the BA
        trigger, where the JAX pipeline reads it."""
        st = self.state
        finite = bool(torch.isfinite(st.t_cur).all()
                      & torch.isfinite(st.R_cur).all())
        if finite:
            self._last_good = st
            return True
        self.num_recoveries += 1
        if self._last_good is not None:
            self.state = self._last_good
        self._inflight_ba = None
        return False

    def _reconcile_ba(self):
        """Fold an in-flight async BA result into the live state."""
        if self._inflight_ba is None:
            return
        ba_map, kf_from, pt_from = self._inflight_ba
        self._inflight_ba = None
        merged = ba_mod.reconcile_async_ba(self.state.map, ba_map, kf_from,
                                           pt_from)
        last = torch.clamp_min(merged.num_kf - 1, 0).long()
        self.state = self.state._replace(
            map=merged, R_cur=_at(merged.kf_R, last),
            t_cur=_at(merged.kf_t, last), t_rel_norm=_ba_step_norm(merged))
        self._maybe_recycle()

    def finish(self):
        """Fold the last async BA and wait for the device (end of
        sequence)."""
        self._reconcile_ba()
        self.block()

    # -- results ----------------------------------------------------------------
    def trajectory(self):
        """Keyframe poses (world->camera) and source frame indices as
        numpy, after folding any in-flight BA."""
        self._reconcile_ba()
        m = self.state.map
        n = int(m.num_kf)
        return (m.kf_R[:n].cpu().numpy(), m.kf_t[:n].cpu().numpy(),
                m.kf_frame_idx[:n].cpu().numpy())

    def map_stats(self) -> dict:
        self._reconcile_ba()
        m = self.state.map
        n_pts = int(m.num_pts)
        valid = m.pts_valid[:n_pts].cpu().numpy()
        bad = m.pts_bad[:n_pts].cpu().numpy()
        return {
            "num_keyframes": int(m.num_kf),
            "num_points": n_pts,
            "num_good_points": int((valid & ~bad).sum()),
            "num_bad_points": int(bad.sum()),
            "num_ba_runs": self._ba_count,
        }

    def stacked_outputs(self):
        """Per-step TrackOutputs (the bootstrap's first) stacked, as
        numpy."""
        if not self.outputs:
            return None
        return frontend.TrackOutputs(*(
            torch.stack(list(xs)).cpu().numpy() for xs in zip(*self.outputs)))

    def block(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
