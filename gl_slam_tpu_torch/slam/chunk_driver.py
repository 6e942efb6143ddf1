"""Host driver for the chunked tracker.

Counterpart of gl_slam_tpu/slam/chunk_driver.py: bootstrap from two images
through the same extractor and matcher the chunks use, then one chunk of T
frames per `track_chunk` call (a partial tail chunk padded and gated by
`frame_gate`), a sliding-window BA pass (slam/ba.py) with
slot recycling every `ba_every` frames, the NaN health check with rollback
at that cadence, and the periodic loop-closure hook (slam/loopclose.py).

Nothing here reads the device back while tracking, apart from a loop
closure that is applied and, under motion-gated keyframing, the chunk's
recovery branch (below): a chunk and its BA pass run under PyTorch's sync
debug mode without a wait for the stream (tests/test_torch_cuda.py).
Frames given as host arrays go up through pinned memory. The BA window is
derived from `num_kf` on the device. The health check works with a
one-period lag: each BA trigger starts a non-blocking copy of `t_cur` into
pinned host memory, marked by a CUDA event, and consumes the copy started
at the previous trigger (waiting on that event only, not on the stream). A non-finite pose rolls the state
back to the last snapshot that was verified finite, up to two BA periods
old. Snapshots alias the live state (all of it, the carried sub-pixel
patches included): state updates never write in place (slam/state.py).

Loop closing (`cfg.runtime.loop_closing`): once more than `loop_min_gap`
frames are tracked, every `loop_check_interval` frames (checked after each
chunk) the keyframe-database detector runs on the carried last-accepted
frame features (`prev_*`: no extra extraction) through the tracker's own
learned matcher. Its verdict is read one interval late, through a pinned
copy and a CUDA event as in the health check; a verified detection is closed
on the host (`loopclose.close_loop`, pose graph over the last
`pose_graph_window` keyframes, the loop edge on the keyframe that was
newest when the detection ran).

Motion-gated keyframing (`every_frame_keyframe=False`) rejects frames as
a matter of course; a rejected frame keeps the state as it was, so the
health check never sees it. The frame after it takes the chunk's recovery
branch (slam/fused.py), whose one host read per frame is this mode's only
wait for the card while tracking; `recovery_frames` lists the frames that
took the branch.

Randomness: the essential RANSAC of the bootstrap and of every frame takes
(hypotheses, 8) uniform draws, in the order bootstrap, then frame by frame
(a frame on the recovery branch reuses its prologue draws).
By default they come from a `torch.Generator` seeded with `seed`; `draws`,
a callable n -> (n, hypotheses, 8) tensor, replaces that source (a test
feeds the JAX reference's own draws through it). Under the PnP tracker
the frames take no essential draws (only the bootstrap does) but one
(pnp_hypotheses, max_keypoints) Gumbel set each for the PnP RANSAC, from
a generator of their own seeded with `seed + 1`; `pnp_draws`, a callable
n -> (n, pnp_hypotheses, max_keypoints), replaces it. Each loop detection
takes its PnP Gumbel draws (loop_candidates, pnp_hypotheses, database
rows) from a generator of its own, seeded with the frame count at the
check, as the JAX version keys it with `PRNGKey(frames)`; `loop_draws`, a
callable frames -> that tensor, replaces it. Detection never touches the
tracker's draws or state, so a run in which no closure fires equals the
run with loop closing off bit for bit. `warmup` draws from throwaway
generators only, so a run with it equals the run without it bit for bit.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import time

import numpy as np
import torch

from .. import tracing
from ..config import SLAMConfig
from ..device import resolve_device, upload
from . import ba as ba_mod
from . import frontend, fused, loopclose
from .state import _at, recycle_free_slots


class ChunkedPipeline:
    """Usage:
        pipe = ChunkedPipeline(cfg, K, sp, lg, chunk=8, ba_every=8)
        pipe.bootstrap_from_images(img0, img1, gt_scale)
        pipe.warmup(first chunk of images)          # optional
        for each chunk of images: pipe.track_chunk(images, frame_idx0)
        pipe.finish()

    `subpix_head`: an optional SubpixHead or PairSubpixHead on the
    pipeline's device (slam/fused.py): the first refines every detection,
    the second the matched keypoints of each chunk.

    `ba_diag` appends to `ba_log`, per BA pass, its `ba.BADiag` (window
    reprojection before and after, live LM iterations: device scalars, read
    by the caller), the host time to issue the pass (ms) and, on a card, a
    pair of CUDA events around it.

    With loop closing on, `loop_checks` holds one entry per detection: the
    frame count at the check, the `LoopDetection` (device tensors) and the
    host time to issue it (ms); `loop_events` one per applied closure.
    """

    def __init__(self, cfg: SLAMConfig, K, sp_net, lg_net, chunk: int = 8,
                 ba_every: int = 8, seed: int = 0, enable_ba: bool = True,
                 device=None,
                 draws: Optional[Callable[[int], torch.Tensor]] = None,
                 ba_diag: bool = False, subpix_head=None,
                 loop_draws: Optional[Callable[[int], torch.Tensor]] = None,
                 pnp_draws: Optional[Callable[[int], torch.Tensor]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32,
                                 device=self.device)
        self.chunk = chunk
        self.sp_net = sp_net
        self.lg_net = lg_net
        self.subpix_head = subpix_head
        self.chunk_fn = fused.build_chunk_fn(cfg, sp_net, lg_net, self.K,
                                             chunk, subpix_head=subpix_head)
        self.extract_fn = fused.build_extract_fn(cfg, sp_net,
                                                 subpix_head=subpix_head)
        self.match_fn = fused.build_matcher(cfg, lg_net)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._draws = draws
        self._pnp = cfg.runtime.tracker == "pnp"
        self._pnp_gen = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self._pnp_draws = pnp_draws
        self.recovery_frames: List[int] = []
        self.enable_ba = enable_ba and cfg.runtime.run_full_ba
        self.ba_every_chunks = max(ba_every // chunk, 1)
        self._win_kf = self.ba_every_chunks * chunk
        self.state: Optional[frontend.TrackState] = None
        self.outputs: List[list] = []
        self._frames = 0
        self._chunks_since_ba = 0
        self.num_ba_runs = 0
        self.num_recoveries = 0
        self._last_good: Optional[frontend.TrackState] = None
        # (host copy of t_cur, its CUDA event or None, the state it belongs to)
        self._pending_health = None
        self._ba_diag = ba_diag
        self.ba_log: List[tuple] = []   # (BADiag, host ms, CUDA events)
        self._last_ba_diag = None
        self._loop_draws = loop_draws
        self._frames_at_loop_check = 0
        # (pinned host copy of det.ok, its CUDA event or None, detection)
        self._pending_loop = None
        self.num_loop_closures = 0
        self.loop_checks: List[dict] = []
        self.loop_events: List[dict] = []
        self._detect_fn = self._build_detect_fn() \
            if cfg.runtime.loop_closing else None

    def draw(self, n: int) -> torch.Tensor:
        """The next n RANSAC draw sets, (n, hypotheses, 8) in [0, 1)."""
        if self._draws is not None:
            u = torch.as_tensor(self._draws(n), dtype=torch.float32)
            return u.to(self.device)
        H = self.cfg.geometry.essential_hypotheses
        return torch.rand((n, H, 8), generator=self._gen,
                          device=self.device)

    def pnp_draw(self, n: int) -> torch.Tensor:
        """The next n PnP RANSAC draw sets, (n, pnp_hypotheses,
        max_keypoints) standard Gumbels."""
        if self._pnp_draws is not None:
            g = torch.as_tensor(self._pnp_draws(n), dtype=torch.float32)
            return g.to(self.device)
        return loopclose.pnp_draws(self._pnp_gen, self._pnp_shape(n),
                                   device=self.device)

    def _pnp_shape(self, n: int):
        cfg = self.cfg
        return (n, cfg.geometry.pnp_hypotheses, cfg.frontend.max_keypoints)

    def _upload(self, a, dtype) -> torch.Tensor:
        return upload(a, dtype, self.device)

    def _images(self, images) -> torch.Tensor:
        return self._upload(images, torch.float32)

    @torch.no_grad()
    def bootstrap_from_images(self, img0, img1, gt_scale: float,
                              frame_idx0: int = 0):
        """Extract both frames, match them with the learned matcher and run
        the two-view bootstrap. Under the pair sub-pixel head the state
        carries frame 1's patches (the bootstrap pair itself keeps the
        centroid refinement, as in the JAX package)."""
        cfg = self.cfg
        imgs = torch.stack([self._images(img0), self._images(img1)])
        feats = self.extract_fn(imgs)
        kp_b, d_b, v_b = feats[:3]
        patches1 = feats[3][1] if len(feats) > 3 else None
        dev = self.device
        f0 = frontend.FrameFeatures(kp_b[0], d_b[0], v_b[0], torch.tensor(
            frame_idx0, dtype=torch.int32, device=dev))
        f1 = frontend.FrameFeatures(kp_b[1], d_b[1], v_b[1], torch.tensor(
            frame_idx0 + 1, dtype=torch.int32, device=dev))
        m = self.match_fn(f0.kpts, f0.desc, f0.valid, f1.kpts, f1.desc,
                          f1.valid)
        st = frontend.init_track_state(
            cfg, device=dev, patch=None if patches1 is None
            else self.subpix_head.patch)
        self.state, out = frontend.bootstrap_step(
            cfg, self.K, st, f0, f1,
            torch.tensor(gt_scale, dtype=torch.float32, device=dev),
            matches=m, u=self.draw(1)[0], patches1=patches1)
        self._frames = frame_idx0 + 2
        return out

    def bootstrap_from_state(self, state: frontend.TrackState,
                             num_frames: int = 2):
        """Adopt an externally bootstrapped state."""
        self.state = state
        self._frames = num_frames

    def _ba_fn(self, st: frontend.TrackState) -> frontend.TrackState:
        """One BA pass over the last `_win_kf` + overlap keyframes, then the
        re-anchoring of the tracking carry and slot recycling. The window
        comes from `num_kf` on the device."""
        cfg, K = self.cfg, self.K
        m = st.map
        first = torch.clamp_min(
            m.num_kf - (self._win_kf + cfg.ba.full_ba_overlap), 0)
        win = m.num_kf - first
        with tracing.span("backend.ba"):
            if self._ba_diag:
                new_map, self._last_ba_diag = ba_mod.ba_step_diag(
                    cfg, K, m, first, win)
            else:
                new_map = ba_mod.ba_step(cfg, K, m, first, win)
        last = torch.clamp_min(new_map.num_kf - 1, 0).long()
        prev = torch.clamp_min(new_map.num_kf - 2, 0).long()
        # Re-anchor the constant-velocity step carry to the BA-refined
        # poses: between BAs it updates multiplicatively from accepted LM
        # steps, so in-bound excursions can compound; the window BA's last
        # two camera centres give the trusted step magnitude.
        R_last, t_last = _at(new_map.kf_R, last), _at(new_map.kf_t, last)
        c_last = -(R_last.T @ t_last)
        c_prev = -(_at(new_map.kf_R, prev).T @ _at(new_map.kf_t, prev))
        step_ba = torch.clamp(torch.linalg.vector_norm(c_last - c_prev),
                              1e-3, 10.0)
        st = st._replace(map=new_map, R_cur=R_last, t_cur=t_last,
                         t_rel_norm=step_ba)
        if cfg.map.recycle_enabled:
            with tracing.span("backend.recycle"):
                st = st._replace(map=recycle_free_slots(
                    st.map, cfg.map.recycle_min_age,
                    min(cfg.map.recycle_budget, cfg.map.max_points),
                    stale_age=cfg.map.recycle_stale_age))
        return st

    @torch.no_grad()
    def warmup(self, images):
        """One chunk of `images`, a BA pass and, with loop closing on, one
        loop detection on a throwaway copy of the state, so that first-call
        set-up (kernel builds, cuDNN plans, the allocator's pools) falls
        outside a timed run. State updates never write in place, so the
        copy is the live state itself; the RANSAC and PnP draws come from
        generators of their own, so the pipeline's state, draws and counters
        are as before."""
        H = self.cfg.geometry.essential_hypotheses
        gen = torch.Generator(device=self.device).manual_seed(0)
        u = torch.rand((self.chunk, H, 8), generator=gen, device=self.device)
        gumbel = loopclose.pnp_draws(gen, self._pnp_shape(self.chunk),
                                     device=self.device) \
            if self._pnp else None
        st, _, _ = self.chunk_fn(self.state, self._images(images),
                                 self._frames, u, pnp_gumbel=gumbel)
        if self.enable_ba:
            st = self._ba_fn(st)
        if self._detect_fn is not None:
            self._detect_fn(st, self._seeded_gumbel(0, st))
        self.finish()

    @torch.no_grad()
    def track_chunk(self, images, frame_idx0: Optional[int] = None,
                    frame_gate=None):
        """Track one chunk of T frames, then run the BA pass and the health
        check when their cadence is due (no host read-back, apart from the
        recovery branch's under motion-gated keyframing). `frame_gate`
        (T,) bool force-rejects the frames where it is False: the padding
        of a partial tail chunk (slam/fused.py)."""
        if frame_idx0 is None:
            frame_idx0 = self._frames
        gate = None if frame_gate is None \
            else self._upload(np.asarray(frame_gate, dtype=bool), torch.bool)
        # the essential RANSAC's draws, or under the PnP tracker the PnP's
        u, gumbel = (None, self.pnp_draw(self.chunk)) if self._pnp \
            else (self.draw(self.chunk), None)
        with tracing.span("chunk", streams=1, step=True, profile=False):
            self.state, outs, recovered = self.chunk_fn(
                self.state, self._images(images), frame_idx0, u,
                frame_gate=gate, pnp_gumbel=gumbel)
        self.outputs.append(outs)
        self.recovery_frames += [frame_idx0 + i
                                 for i, r in enumerate(recovered) if r]
        self._frames += self.chunk
        self._chunks_since_ba += 1
        if self.enable_ba and self._chunks_since_ba >= self.ba_every_chunks:
            self._chunks_since_ba = 0
            if self._ba_diag:
                self._timed_ba_pass()
            else:
                self.state = self._ba_fn(self.state)
            self.num_ba_runs += 1
            self._health_check()
        self._maybe_loop_close()
        return outs

    def _timed_ba_pass(self):
        """The BA pass between two CUDA events (none on the CPU) and two
        reads of the host clock; nothing waits for the device."""
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        self.state = self._ba_fn(self.state)
        host_ms = (time.perf_counter() - t0) * 1e3
        if events is not None:
            events[1].record()
        self.ba_log.append((self._last_ba_diag, host_ms, events))

    def _health_check(self):
        """NaN health check + rollback at BA cadence, one period late: this
        trigger consumes the `t_cur` whose host copy the previous trigger
        started, then starts the copy of the current one."""
        if not self.cfg.runtime.health_check:
            return
        if self._pending_health is not None:
            host_t, event, snapshot = self._pending_health
            if event is not None:
                # waits for work up to the previous trigger, not for what
                # was queued since
                event.synchronize()
            if bool(torch.isfinite(host_t).all()):
                self._last_good = snapshot
            else:
                self.num_recoveries += 1
                self._pending_health = None
                if self._last_good is not None:
                    self.state = self._last_good
                return
        snap = self.state
        if snap.t_cur.is_cuda:
            host_t = torch.empty(snap.t_cur.shape, dtype=snap.t_cur.dtype,
                                 pin_memory=True)
            host_t.copy_(snap.t_cur, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(snap.t_cur.device))
        else:
            host_t, event = snap.t_cur, None
        self._pending_health = (host_t, event, snap)

    # -- loop closing ------------------------------------------------------
    def _build_detect_fn(self):
        """The keyframe-database detector on a tracking state: the
        tracker's learned matcher (`fused.build_matcher`: LightGlue and the
        fused assignment, through the kernels on the card) over the carried
        `prev_kpts` / `prev_desc` / `prev_valid`."""
        cfg, K, match_fn = self.cfg, self.K, self.match_fn

        def detect_fn(st: frontend.TrackState, gumbel: torch.Tensor):
            f = frontend.FrameFeatures(st.prev_kpts, st.prev_desc,
                                       st.prev_valid, None)
            return loopclose.detect_loop(
                cfg, K, st.map, f, gumbel, min_gap=cfg.runtime.loop_min_gap,
                matcher=match_fn, R_cur=st.R_cur, t_cur=st.t_cur)

        return detect_fn

    def _loop_gumbel(self, frames: int) -> torch.Tensor:
        """The PnP draws of the detection at frame count `frames`."""
        if self._loop_draws is not None:
            g = torch.as_tensor(self._loop_draws(frames), dtype=torch.float32)
            return g.to(self.device)
        return self._seeded_gumbel(frames, self.state)

    def _seeded_gumbel(self, seed: int, st) -> torch.Tensor:
        cfg = self.cfg
        shape = (cfg.runtime.loop_candidates, cfg.geometry.pnp_hypotheses,
                 st.map.kf_db_idx.shape[1])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return loopclose.pnp_draws(gen, shape, device=self.device)

    def _dispatch_detect(self):
        """Issue one detection and start the copy of its verdict."""
        t0 = time.perf_counter()
        with tracing.span("loop.detect"):
            det = self._detect_fn(self.state,
                                  self._loop_gumbel(self._frames))
        if det.ok.is_cuda:
            host_ok = torch.empty((), dtype=torch.bool, pin_memory=True)
            host_ok.copy_(det.ok, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(det.ok.device))
        else:
            host_ok, event = det.ok, None
        self.loop_checks.append(dict(
            frames=self._frames, det=det,
            host_ms=(time.perf_counter() - t0) * 1e3))
        self._pending_loop = (host_ok, event, det)

    def _maybe_loop_close(self):
        """Loop-closure cadence, checked after each chunk: past
        `loop_min_gap` frames, once every `loop_check_interval` frames,
        consume the previous check's verdict (closing the loop it found)
        and issue the next detection."""
        rt = self.cfg.runtime
        if not rt.loop_closing or self.state is None:
            return
        if self._frames <= rt.loop_min_gap:
            return
        if self._frames - self._frames_at_loop_check < rt.loop_check_interval:
            return
        self._frames_at_loop_check = self._frames
        if self._pending_loop is not None:
            host_ok, event, det = self._pending_loop
            self._pending_loop = None
            if event is not None:
                event.synchronize()    # the work up to that check only
            if bool(host_ok):
                t0 = time.perf_counter()
                with tracing.span("loop.close"):
                    self.state = loopclose.close_loop(
                        self.cfg, self.K, self.state, det,
                        rt.pose_graph_window, target_kf=int(det.cur_kf) - 1)
                self.num_loop_closures += 1
                self.loop_events.append(dict(
                    applied_at_frame=self._frames,
                    detected_at_kf=int(det.cur_kf) - 1,
                    loop_kf=int(det.loop_kf),
                    pnp_inliers=int(det.num_inliers),
                    host_ms=(time.perf_counter() - t0) * 1e3))
        self._dispatch_detect()

    def finish(self):
        """Wait for the device to finish all enqueued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def trajectory(self):
        """Keyframe poses (R (k,3,3), t (k,3)) and source frame indices."""
        m = self.state.map
        n = int(m.num_kf)
        return (m.kf_R[:n].cpu().numpy(), m.kf_t[:n].cpu().numpy(),
                m.kf_frame_idx[:n].cpu().numpy())

    def stacked_outputs(self):
        """Per-frame TrackOutputs stacked over all chunks, as numpy."""
        if not self.outputs:
            return None
        frames = [o for outs in self.outputs for o in outs]
        return frontend.TrackOutputs(*(
            torch.stack(list(xs)).cpu().numpy() for xs in zip(*frames)))
