"""Multi-stream SLAM: S concurrent sequences in lock step.

Counterpart of gl_slam_tpu/parallel/multistream.py (BASELINE configs[4]:
16 concurrent KITTI sequences per chip). The JAX tracker vmaps the
tracking step over a stream axis; here the state carries an explicit
leading stream axis (frontend.init_track_state(..., num_streams=S)) and
the step, the bootstrap and the window BA run every stream in one call
(slam/state.py keeps each stream's reads and writes in its own tables).

The random draws are arguments, as everywhere in the port: each stream's
essential RANSAC draws (hypotheses, 8) come from a generator of its own,
seeded with `seed + s`, unless the caller passes `u` (S, hypotheses, 8).

`devices` (parallel/mesh.make_mesh) splits the streams evenly over
several cards, each part tracked on its own with no operation across
parts (the JAX tracker's sharded mesh). Outputs are gathered onto the
first device. With one card the split is the identity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import SLAMConfig
from ..device import resolve_device
from ..slam import ba as ba_mod
from ..slam import frontend
from ..slam.state import _at, tree_map
from . import mesh as mesh_lib


class MultiStreamTracker:
    """Lock-step tracker over S independent sequences.

    Usage:
        ms = MultiStreamTracker(cfg, K, S)
        ms.bootstrap((kpts0, desc0, valid0), (kpts1, ...), gt_scales)
        ms.step(kpts, desc, valid, frame_idx)      # (S, N, ...) each
        ms.ba(first_kf, window)
        ms.block()

    Features are stream-batched: kpts (S, N, 2), desc (S, N, D), valid
    (S, N). K is (3, 3) shared by all streams, or (S, 3, 3), one camera
    per stream, split over the parts with the stream axis."""

    def __init__(self, cfg: SLAMConfig, K, num_streams: int,
                 devices: Optional[Sequence] = None, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.S = num_streams
        self.devices = None if devices is None \
            else [torch.device(d) for d in devices]
        home = resolve_device(device) if self.devices is None \
            else self.devices[0]
        self.device = home
        K = torch.as_tensor(np.asarray(K), dtype=torch.float32)
        if K.dim() == 3 and K.shape[0] != num_streams:
            raise ValueError(f"K of shape {tuple(K.shape)} for "
                             f"{num_streams} streams")
        self._parts = mesh_lib.stream_parts(num_streams, self.devices)
        self._K = [(K if K.dim() == 2 else K[sl]).to(d or home)
                   for d, sl in self._parts]
        self.states = [frontend.init_track_state(
            cfg, device=d or home, num_streams=sl.stop - sl.start)
            for d, sl in self._parts]
        self._gens = [torch.Generator(device=home).manual_seed(seed + s)
                      for s in range(num_streams)]

    @property
    def state(self) -> frontend.TrackState:
        """The stream-batched state (parts joined on the first device)."""
        if len(self.states) == 1:
            return self.states[0]
        return mesh_lib.gather_streams(self.states, self.device)

    @state.setter
    def state(self, st: frontend.TrackState):
        """Adopt a stream-batched state (for example the one a multi-stream
        chunk returns), split over the parts."""
        if len(self._parts) == 1:
            self.states = [st]
        else:
            self.states = mesh_lib.shard_streams(st, self.devices)

    def draw(self) -> torch.Tensor:
        """The next (S, hypotheses, 8) RANSAC draws, one row per stream
        from its own generator."""
        H = self.cfg.geometry.essential_hypotheses
        return torch.stack([torch.rand((H, 8), generator=g,
                                       device=self.device)
                            for g in self._gens])

    def _run(self, fn, *per_stream):
        """fn(part index, K, state, *inputs) on every part; inputs are
        stream-batched and split like the state; the outputs are joined."""
        outs = []
        for p, (d, sl) in enumerate(self._parts):
            dev = d or self.device
            args = [None if x is None else
                    tree_map(lambda a: a[sl].to(dev), x)
                    for x in per_stream]
            self.states[p], out = fn(self._K[p], self.states[p], *args)
            outs.append(out)
        if outs[0] is None:
            return None
        return outs[0] if len(outs) == 1 \
            else mesh_lib.gather_streams(outs, self.device)

    def _feats(self, kpts, desc, valid, frame_idx):
        dev = self.device

        def up(a, dtype):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                   else a).to(dev, dtype)

        return frontend.FrameFeatures(
            kpts=up(kpts, torch.float32), desc=up(desc, torch.float32),
            valid=up(valid, torch.bool),
            frame_idx=torch.full((self.S,), int(frame_idx), dtype=torch.int32,
                                 device=dev))

    @torch.no_grad()
    def bootstrap(self, f0, f1, gt_scales, u=None):
        """f0/f1: tuples of stream-batched (kpts (S, N, 2), desc, valid);
        `gt_scales` (S,). Mutual nearest-neighbour matching, as the JAX
        tracker's bootstrap."""
        feats0 = self._feats(*f0, 0)
        feats1 = self._feats(*f1, 1)
        u = self.draw() if u is None else torch.as_tensor(u).to(
            self.device, torch.float32)
        scales = torch.as_tensor(np.asarray(gt_scales, np.float32)).to(
            self.device)
        cfg = self.cfg
        return self._run(
            lambda K, st, a, b, sc, uu: frontend.bootstrap_step(
                cfg, K, st, a, b, sc, u=uu),
            feats0, feats1, scales, u)

    @torch.no_grad()
    def step(self, kpts, desc, valid, frame_idx: int, u=None,
             pnp_gumbel=None):
        """Track one frame of every stream (mutual nearest-neighbour pass-1
        and re-observation matching, as the JAX tracker's step). `u` (S,
        hypotheses, 8) draws, default from the per-stream generators;
        `pnp_gumbel` (S, pnp_hypotheses, N) under the PnP tracker."""
        feats = self._feats(kpts, desc, valid, frame_idx)
        if self.cfg.runtime.tracker == "pnp":
            if pnp_gumbel is None:
                raise ValueError("the PnP tracker needs `pnp_gumbel`")
            u = None
        elif u is None:
            u = self.draw()
        else:
            u = torch.as_tensor(u).to(self.device, torch.float32)
        g = None if pnp_gumbel is None else torch.as_tensor(
            pnp_gumbel).to(self.device, torch.float32)
        cfg = self.cfg
        return self._run(
            lambda K, st, f, uu, gg: frontend.track_step(
                cfg, K, st, f, uu, pnp_gumbel=gg),
            feats, u, g)

    def _per_stream_i32(self, x) -> torch.Tensor:
        if torch.is_tensor(x):
            return x.to(self.device, torch.int32).expand(self.S)
        return torch.as_tensor(np.broadcast_to(np.asarray(x, np.int32),
                                               (self.S,)).copy()).to(
            self.device)

    @torch.no_grad()
    def ba(self, first_kf, window):
        """One window BA pass per stream (`first_kf`, `window`: ints, (S,)
        arrays or (S,) device tensors, which are not read back), then
        `R_cur` / `t_cur` re-anchored to each stream's last keyframe, as
        the JAX tracker does (no slot recycling, no re-anchoring of
        `t_rel_norm`)."""
        fk = self._per_stream_i32(first_kf)
        win = self._per_stream_i32(window)
        cfg = self.cfg

        def one(K, st, f, w):
            new_map = ba_mod.ba_step(cfg, K, st.map, f, w)
            idx = torch.clamp(new_map.num_kf - 1, 0,
                              new_map.capacity_kf - 1)
            return st._replace(map=new_map,
                               R_cur=_at(new_map.kf_R, idx, 1),
                               t_cur=_at(new_map.kf_t, idx, 1)), None

        self._run(one, fk, win)

    def block(self):
        """Wait for every part's device to finish its queued work."""
        for d, _ in self._parts:
            dev = d or self.device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
