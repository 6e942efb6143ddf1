"""End-to-end learned tracking on a rendered scene, scored as ATE.

Counterpart of the inference half of gl_slam_tpu/train/e2e.py: build the
SuperPoint and LightGlue networks and the sub-pixel heads (single-view and
pair) at the committed checkpoints' shapes, load their weights, and track
a rendered sequence through the chunked pipeline with its periodic window
BA and loop closing. Training is train/frontend_train.py.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import checkpoint as ckpt
# flagship_config and micro_config are reachable from here, as in JAX
from ..config import (FLAGSHIP_DESC_DIM, FLAGSHIP_LG, FLAGSHIP_SP_CHANNELS,
                      TINY_DESC_DIM, TINY_LG, TINY_SP_CHANNELS, SLAMConfig,
                      flagship_config, micro_config)  # noqa: F401
from ..device import resolve_device
from ..io import synthetic
from ..models.lightglue import LightGlueNet
from ..models.subpix import PairSubpixHead, SubpixHead
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
    num_ba_runs: int = 0
    loop_closures: int = 0


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


def _load_subpix(ckpt_dir, tag, D, device, dtype, pair):
    path = ckpt.params_path(ckpt_dir, f"kspair_{tag}" if pair
                            else f"ks_{tag}")
    if not os.path.exists(path):
        return None
    cls = PairSubpixHead if pair else SubpixHead
    head = cls(D, patch=7, offset_range=1.5,
               dtype=torch.bfloat16 if dtype is None else dtype)
    ckpt.load_module(head, path, ckpt.subpix_state_dict)
    return head.to(resolve_device(device)).eval()


def load_flagship_subpix(ckpt_dir: str = "checkpoints", pair: bool = True,
                         device=None,
                         dtype: Optional[torch.dtype] = None):
    """The trained flagship sub-pixel head, 7 x 7 patches, D 256: with
    `pair` the PairSubpixHead of kspair_flagship.npz (input width 611),
    else the single-view SubpixHead of ks_flagship.npz (input width 305);
    None if the checkpoint is missing. `dtype`: the hidden layers' compute
    dtype (default bfloat16, as the JAX package)."""
    return _load_subpix(ckpt_dir, "flagship", FLAGSHIP_DESC_DIM, device,
                        dtype, pair)


def load_tiny_subpix(ckpt_dir: str = "checkpoints", pair: bool = False,
                     device=None, dtype: Optional[torch.dtype] = None):
    """The tiny preset's sub-pixel head (D 64): the single-view SubpixHead
    of ks_tiny.npz, or with `pair` the PairSubpixHead of kspair_tiny.npz.
    The defaults of `pair` are the JAX package's."""
    return _load_subpix(ckpt_dir, "tiny", TINY_DESC_DIM, device, dtype,
                        pair)


def render_stack(scene, n_frames: int, max_keypoints: int,
                 domain: str = "clean") -> np.ndarray:
    """The first `n_frames` rendered frames, (n, H, W) float32, written
    frame by frame into one array (a 1000-frame flagship stack is 1.9 GB)."""
    first = synthetic.render_frame(scene, 0, max_keypoints=max_keypoints,
                                   domain=domain)
    out = np.empty((n_frames,) + first.shape, np.float32)
    out[0] = first
    for i in range(1, n_frames):
        out[i] = synthetic.render_frame(scene, i, max_keypoints=max_keypoints,
                                        domain=domain)
    return out


def load_or_render(scene, n_frames: int, max_keypoints: int,
                   render_cache: Optional[str] = None,
                   domain: str = "clean") -> np.ndarray:
    """`render_stack`, read from the .npy `render_cache` when it exists (it
    must hold `n_frames` frames or more; it may hold more), else rendered
    and saved there (a write that fails costs the cache only)."""
    if render_cache is not None and os.path.exists(render_cache):
        stack = np.load(render_cache)
        if stack.shape[0] < n_frames:
            raise ValueError(f"{render_cache} holds {stack.shape[0]} frames, "
                             f"fewer than {n_frames}")
        return stack
    stack = render_stack(scene, n_frames, max_keypoints, domain=domain)
    if render_cache is not None:
        try:
            np.save(render_cache, stack)
        except OSError as e:
            warnings.warn(f"render cache {render_cache} not written: {e}")
            if os.path.exists(render_cache):
                os.remove(render_cache)
    return stack


def run_learned_e2e(sp, lg, scene, cfg: SLAMConfig, n_frames: int,
                    chunk: int = 5, ba_every: int = 3, device=None,
                    seed: int = 0,
                    draws: Optional[Callable[[int], torch.Tensor]] = None,
                    stack: Optional[np.ndarray] = None,
                    diag_out: Optional[dict] = None,
                    ba_diag: bool = False, subpix=None,
                    domain: str = "clean",
                    pnp_draws: Optional[Callable[[int], torch.Tensor]] = None,
                    warmup: bool = False,
                    render_cache: Optional[str] = None,
                    on_chunk: Optional[Callable[[int, ChunkedPipeline],
                                                None]] = None
                    ) -> E2EResult:
    """Bootstrap on frames 0-1, then track whole chunks of `chunk` frames of
    `scene`, with a window BA pass every `ba_every` frames (rounded to whole
    chunks) when `cfg.runtime.run_full_ba` is on, and the loop-closure
    checks when `cfg.runtime.loop_closing` is on; ATE-RMSE of the keyframe
    camera centres against ground truth. `stack`: pre-rendered frames
    (else rendered here in `domain`, outside the timed region). `draws`
    and `pnp_draws` replace the pipeline's essential and PnP RANSAC draws
    (ChunkedPipeline). fps counts the
    tracked frames after the bootstrap over the host wall time up to the
    final device synchronisation. `diag_out` receives the per-frame
    outputs, the trajectory, the final tracking state, the recovery count,
    `recovery_frames` (the frames whose pass-1 match took the chunk's
    recovery branch), the state's size in bytes, `loop_events` (one dict
    per applied
    closure) and `loop_checks` (per detection: the frame count, the
    LoopDetection, the host ms to issue it). `ba_diag` (off by default: it
    adds two reprojection passes to every BA) also puts there, per BA
    pass, `ba_reproj` (the window's mean reprojection error in px before
    and after), `ba_lm_iters` (LM iterations before the carry froze) and
    `ba_ms` (host time to issue the pass, and time between two CUDA events
    around it or None on the CPU). `subpix`: an optional sub-pixel head
    (load_*_subpix): a SubpixHead refines every detection, a PairSubpixHead
    the matched keypoints in every chunk; None keeps the centroid
    refinement. `render_cache`: a .npy path; the rendered stack is read
    from it when it exists (it must hold `n_frames` frames or more), else
    rendered and saved there. `warmup` runs one chunk of the first frames,
    a BA pass and a loop detection on a throwaway state before the timed
    loop (ChunkedPipeline.warmup), so first-call set-up falls outside the
    fps; neither changes the trajectory. `on_chunk(frames, pipe)` is called
    after each tracked chunk with the frame count so far (inside the timed
    loop: what it reads from the card costs fps)."""
    dev = resolve_device(device)
    if stack is None:
        stack = load_or_render(scene, n_frames, cfg.frontend.max_keypoints,
                               render_cache, domain)
    pipe = ChunkedPipeline(cfg, scene.K, sp, lg, chunk=chunk,
                           ba_every=ba_every, seed=seed, device=dev,
                           draws=draws, pnp_draws=pnp_draws,
                           ba_diag=diag_out is not None and ba_diag,
                           subpix_head=subpix)
    c0 = -scene.poses_R[0].T @ scene.poses_t[0]
    c1 = -scene.poses_R[1].T @ scene.poses_t[1]
    pipe.bootstrap_from_images(stack[0], stack[1],
                               float(np.linalg.norm(c1 - c0)))
    frames = torch.from_numpy(stack[2:n_frames]).to(dev)
    del stack
    if warmup:
        pipe.warmup(frames[:chunk])

    pipe.finish()
    t0 = time.perf_counter()
    start = 2
    while start + chunk <= n_frames:
        pipe.track_chunk(frames[start - 2:start - 2 + chunk], start)
        start += chunk
        if on_chunk is not None:
            on_chunk(start, pipe)
    pipe.finish()
    wall = time.perf_counter() - t0

    o = pipe.stacked_outputs()
    R_est, t_est, fidx = pipe.trajectory()
    c_est = np.einsum('kij,kj->ki', R_est.transpose(0, 2, 1), -t_est)
    c_gt = np.stack([-scene.poses_R[i].T @ scene.poses_t[i] for i in fidx])
    ate = float(np.sqrt(((c_est - c_gt) ** 2).sum(1).mean()))
    if diag_out is not None:
        diag_out.update(
            outputs=o, R=R_est, t=t_est, frame_idx=fidx, state=pipe.state,
            num_recoveries=pipe.num_recoveries,
            recovery_frames=pipe.recovery_frames,
            loop_events=pipe.loop_events, loop_checks=pipe.loop_checks,
            state_bytes=sum(x.numel() * x.element_size() for x in
                            (*pipe.state.map, *pipe.state[1:])
                            if x is not None))
        if ba_diag:
            diag_out.update(
                ba_reproj=[(float(d.reproj_before), float(d.reproj_after))
                           for d, _, _ in pipe.ba_log],
                ba_lm_iters=[int(d.lm_iters) for d, _, _ in pipe.ba_log],
                ba_ms=[(host, ev[0].elapsed_time(ev[1]) if ev else None)
                       for _, host, ev in pipe.ba_log])
    oks = o.frame_ok
    return E2EResult(
        ate_m=ate, num_keyframes=len(fidx), num_frames=start,
        fps=(start - 2) / max(wall, 1e-9),
        mean_matches=float(o.num_matches.mean()),
        num_rejected=int((~oks).sum()),
        mean_inliers=float(o.num_inliers.mean()),
        mean_pose_cost=float(o.pose_cost[oks].mean()) if oks.any() else 0.0,
        total_new_points=int(o.num_new_points.sum()),
        num_ba_runs=pipe.num_ba_runs,
        loop_closures=pipe.num_loop_closures)
