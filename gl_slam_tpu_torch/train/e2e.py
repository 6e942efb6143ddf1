"""End-to-end learned tracking on a rendered scene, scored as ATE.

Counterpart of the inference half of gl_slam_tpu/train/e2e.py: build the
SuperPoint and LightGlue networks at the committed checkpoints' shapes,
load their weights, and track a rendered sequence through the chunked
pipeline. Training is not ported.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..config import (FLAGSHIP_DESC_DIM, FLAGSHIP_LG, FLAGSHIP_SP_CHANNELS,
                      TINY_DESC_DIM, TINY_LG, TINY_SP_CHANNELS, SLAMConfig)
from ..device import resolve_device
from ..io import synthetic
from ..models.lightglue import LightGlueNet
from ..models.superpoint import SuperPointNet
from ..slam.chunk_driver import ChunkedPipeline


class E2EResult(NamedTuple):
    ate_m: float
    num_keyframes: int
    num_frames: int
    fps: float
    mean_matches: float
    num_rejected: int
    mean_inliers: float
    mean_pose_cost: float
    total_new_points: int


def _load_frontend(ckpt_dir, tag, D, channels, lg_shape, device, dtype):
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16
    sp = SuperPointNet(descriptor_dim=D, channels=channels, dtype=dtype)
    lg = LightGlueNet(input_dim=D, dtype=dtype, **lg_shape)
    ckpt.load_module(sp, ckpt.params_path(ckpt_dir, f"sp_{tag}"),
                     ckpt.superpoint_state_dict)
    ckpt.load_module(lg, ckpt.params_path(ckpt_dir, f"lg_{tag}"),
                     ckpt.lightglue_state_dict)
    return sp.to(dev).eval(), lg.to(dev).eval()


def load_flagship_frontend(ckpt_dir: str = "checkpoints", device=None,
                           dtype: Optional[torch.dtype] = None):
    """Flagship SuperPointNet + LightGlueNet (N=2048, D=256, 9 layers of 2
    heads) with the committed weights -> (sp, lg). `dtype` is the compute
    dtype (default bfloat16, as the JAX package); weights stay float32."""
    return _load_frontend(ckpt_dir, "flagship", FLAGSHIP_DESC_DIM,
                          FLAGSHIP_SP_CHANNELS, FLAGSHIP_LG, device, dtype)


def load_tiny_frontend(ckpt_dir: str = "checkpoints", device=None,
                       dtype: Optional[torch.dtype] = None):
    """The tiny preset's networks with the committed weights -> (sp, lg)."""
    return _load_frontend(ckpt_dir, "tiny", TINY_DESC_DIM, TINY_SP_CHANNELS,
                          TINY_LG, device, dtype)


def render_stack(scene, n_frames: int, max_keypoints: int,
                 domain: str = "clean") -> np.ndarray:
    """The first `n_frames` rendered frames, (n, H, W) float32."""
    return np.stack([synthetic.render_frame(scene, i,
                                            max_keypoints=max_keypoints,
                                            domain=domain)
                     for i in range(n_frames)]).astype(np.float32)


def run_learned_e2e(sp, lg, scene, cfg: SLAMConfig, n_frames: int,
                    chunk: int = 5, device=None, seed: int = 0,
                    draws: Optional[Callable[[int], torch.Tensor]] = None,
                    stack: Optional[np.ndarray] = None,
                    diag_out: Optional[dict] = None) -> E2EResult:
    """Bootstrap on frames 0-1, then track whole chunks of `chunk` frames of
    `scene` (BA and loop closing must be off in `cfg`); ATE-RMSE of the
    keyframe camera centres against ground truth. `stack`: pre-rendered
    frames (else rendered here, outside the timed region). fps counts the
    tracked frames after the bootstrap over the host wall time up to the
    final device synchronisation. `diag_out` receives the per-frame outputs
    and the trajectory."""
    dev = resolve_device(device)
    if stack is None:
        stack = render_stack(scene, n_frames, cfg.frontend.max_keypoints)
    pipe = ChunkedPipeline(cfg, scene.K, sp, lg, chunk=chunk, seed=seed,
                           device=dev, draws=draws)
    c0 = -scene.poses_R[0].T @ scene.poses_t[0]
    c1 = -scene.poses_R[1].T @ scene.poses_t[1]
    pipe.bootstrap_from_images(stack[0], stack[1],
                               float(np.linalg.norm(c1 - c0)))
    frames = torch.from_numpy(stack[2:n_frames]).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    start = 2
    while start + chunk <= n_frames:
        pipe.track_chunk(frames[start - 2:start - 2 + chunk], start)
        start += chunk
    sync()
    wall = time.perf_counter() - t0

    o = pipe.stacked_outputs()
    R_est, t_est, fidx = pipe.trajectory()
    c_est = np.einsum('kij,kj->ki', R_est.transpose(0, 2, 1), -t_est)
    c_gt = np.stack([-scene.poses_R[i].T @ scene.poses_t[i] for i in fidx])
    ate = float(np.sqrt(((c_est - c_gt) ** 2).sum(1).mean()))
    if diag_out is not None:
        diag_out.update(outputs=o, R=R_est, t=t_est, frame_idx=fidx)
    oks = o.frame_ok
    return E2EResult(
        ate_m=ate, num_keyframes=len(fidx), num_frames=start,
        fps=(start - 2) / max(wall, 1e-9),
        mean_matches=float(o.num_matches.mean()),
        num_rejected=int((~oks).sum()),
        mean_inliers=float(o.num_inliers.mean()),
        mean_pose_cost=float(o.pose_cost[oks].mean()) if oks.any() else 0.0,
        total_new_points=int(o.num_new_points.sum()))
