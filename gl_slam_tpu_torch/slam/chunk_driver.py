"""Host driver for the chunked tracker.

Counterpart of gl_slam_tpu/slam/chunk_driver.py: bootstrap from two images
through the same extractor and matcher the chunks use, then one chunk of T
frames per `track_chunk` call. The window BA, slot recycling, health check
and loop-closure hooks of the JAX driver are not ported yet: asking for
them raises instead of silently skipping them.

Randomness: the essential RANSAC of the bootstrap and of every frame takes
(hypotheses, 8) uniform draws, in the order bootstrap, then frame by frame.
By default they come from a `torch.Generator` seeded with `seed`; `draws`,
a callable n -> (n, hypotheses, 8) tensor, replaces that source (a test
feeds the JAX reference's own draws through it).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import SLAMConfig
from ..device import resolve_device
from . import frontend, fused


class ChunkedPipeline:
    """Usage:
        pipe = ChunkedPipeline(cfg, K, sp, lg, chunk=8)
        pipe.bootstrap_from_images(img0, img1, gt_scale)
        for each chunk of images: pipe.track_chunk(images, frame_idx0)
    """

    def __init__(self, cfg: SLAMConfig, K, sp_net, lg_net, chunk: int = 8,
                 seed: int = 0, enable_ba: bool = True,
                 device=None,
                 draws: Optional[Callable[[int], torch.Tensor]] = None):
        if enable_ba and cfg.runtime.run_full_ba:
            raise NotImplementedError(
                "window BA (slam/ba.py) is not ported yet; see ROADMAP.md "
                "- pass enable_ba=False or RuntimeConfig(run_full_ba=False)")
        if cfg.runtime.loop_closing:
            raise NotImplementedError(
                "loop closing (slam/loopclose.py) is not ported yet; see "
                "ROADMAP.md - use RuntimeConfig(loop_closing=False)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32,
                                 device=self.device)
        self.chunk = chunk
        self.sp_net = sp_net
        self.lg_net = lg_net
        self.chunk_fn = fused.build_chunk_fn(cfg, sp_net, lg_net, self.K,
                                             chunk)
        self.extract_fn = fused.build_extract_fn(cfg, sp_net)
        self.match_fn = fused.build_matcher(cfg, lg_net)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._draws = draws
        self.state: Optional[frontend.TrackState] = None
        self.outputs: List[list] = []
        self._frames = 0

    def draw(self, n: int) -> torch.Tensor:
        """The next n RANSAC draw sets, (n, hypotheses, 8) in [0, 1)."""
        if self._draws is not None:
            u = torch.as_tensor(self._draws(n), dtype=torch.float32)
            return u.to(self.device)
        H = self.cfg.geometry.essential_hypotheses
        return torch.rand((n, H, 8), generator=self._gen,
                          device=self.device)

    def _images(self, images) -> torch.Tensor:
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, dtype=np.float32))
        return images.to(self.device, torch.float32)

    @torch.no_grad()
    def bootstrap_from_images(self, img0, img1, gt_scale: float,
                              frame_idx0: int = 0):
        """Extract both frames, match them with the learned matcher and run
        the two-view bootstrap."""
        cfg = self.cfg
        imgs = torch.stack([self._images(img0), self._images(img1)])
        kp_b, d_b, v_b = self.extract_fn(imgs)
        dev = self.device
        f0 = frontend.FrameFeatures(kp_b[0], d_b[0], v_b[0], torch.tensor(
            frame_idx0, dtype=torch.int32, device=dev))
        f1 = frontend.FrameFeatures(kp_b[1], d_b[1], v_b[1], torch.tensor(
            frame_idx0 + 1, dtype=torch.int32, device=dev))
        m = self.match_fn(f0.kpts, f0.desc, f0.valid, f1.kpts, f1.desc,
                          f1.valid)
        st = frontend.init_track_state(cfg, device=dev)
        self.state, out = frontend.bootstrap_step(
            cfg, self.K, st, f0, f1,
            torch.tensor(gt_scale, dtype=torch.float32, device=dev),
            matches=m, u=self.draw(1)[0])
        self._frames = frame_idx0 + 2
        return out

    @torch.no_grad()
    def track_chunk(self, images, frame_idx0: Optional[int] = None):
        """Track one chunk of T frames (no host read-back)."""
        if frame_idx0 is None:
            frame_idx0 = self._frames
        self.state, outs = self.chunk_fn(self.state, self._images(images),
                                         frame_idx0, self.draw(self.chunk))
        self.outputs.append(outs)
        self._frames += self.chunk
        return outs

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
