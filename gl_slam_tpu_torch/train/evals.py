"""The flagship evaluations of the port: the 120-frame flagship scenario
and the loop-closure A/B, each as one report (a dict of JSON values).

Counterparts of scripts/eval_flagship.py and scripts/eval_loopclose.py of
the JAX package, at their committed settings, through the port's normal
entry point `run_learned_e2e`; `scripts/eval_flagship_torch.py` and
`scripts/eval_loopclose_torch.py` write them to FLAGSHIP_EVAL_TORCH.json
and LOOPCLOSE_EVAL_TORCH.json, and `chip_smoke.py` runs the first one.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import List, Optional

import numpy as np

from ..config import SLAMConfig, flagship_config
from ..device import resolve_device
from ..io import synthetic
from . import e2e


def device_line(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them; "cpu" on the CPU."""
    if resolve_device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def loop_checks_implied(cfg: SLAMConfig, n_frames: int,
                        chunk: int) -> List[int]:
    """Frame counts at which the chunked driver runs a loop detection over
    a bootstrap plus whole chunks of `n_frames` frames (its cadence: after
    each chunk, past `loop_min_gap` frames, every `loop_check_interval`)."""
    rt = cfg.runtime
    if not rt.loop_closing:
        return []
    checks, last, frames = [], 0, 2
    while frames + chunk <= n_frames:
        frames += chunk
        if frames > rt.loop_min_gap and \
                frames - last >= rt.loop_check_interval:
            checks.append(frames)
            last = frames
    return checks


def _loop_diag(diag: dict) -> dict:
    return dict(
        loop_checks=[c["frames"] for c in diag["loop_checks"]],
        detect_host_ms=[c["host_ms"] for c in diag["loop_checks"]],
        loop_events=diag["loop_events"])


def flagship_eval(ckpt_dir: str, frames: int = 120, seed: int = 101,
                  landmarks: int = 20000, chunk: int = 8,
                  motion: str = "forward_turn", subpix: str = "pair",
                  domain: str = "clean", reobs_mode: str = "separate",
                  device=None, warmup: bool = True,
                  diag_out: Optional[dict] = None) -> dict:
    """The flagship scenario: `flagship_config()` (376x1241, N=2048,
    D=256, 9-layer matcher on all three passes, loop closing on), the
    committed flagship weights, window BA every 8 frames, over a held-out
    rendered sequence; ATE and tracked fps from the same run. `subpix`:
    "pair" (the learned pair head), "single" (the single-view head) or
    "centroid". `reobs_mode`: the re-observation passes, "separate" (the
    reference's LightGlue x3 a frame), "merged" or "batched" (x2; see
    slam/reobserve.py). `warmup` first tracks
    the bootstrap plus one chunk (cuDNN plans, allocator) outside the
    measured run. `diag_out` receives run_learned_e2e's diagnostics."""
    dev = resolve_device(device)
    if subpix not in ("pair", "single", "centroid"):
        raise ValueError(f"subpix={subpix!r}")
    if reobs_mode not in ("separate", "merged", "batched"):
        raise ValueError(f"reobs_mode={reobs_mode!r}")
    cfg = flagship_config()
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, reobs_mode=reobs_mode))
    sp, lg = e2e.load_flagship_frontend(ckpt_dir, device=dev)
    head = None
    if subpix != "centroid":
        head = e2e.load_flagship_subpix(ckpt_dir, pair=subpix == "pair",
                                        device=dev)
        if head is None:
            raise FileNotFoundError(f"no {subpix} sub-pixel checkpoint in "
                                    f"{ckpt_dir}")
    scene = synthetic.make_scene(
        num_landmarks=landmarks, num_frames=frames,
        height=cfg.frontend.image_height, width=cfg.frontend.image_width,
        desc_dim=cfg.frontend.descriptor_dim, seed=seed, motion=motion)
    t0 = time.perf_counter()
    stack = e2e.render_stack(scene, frames, cfg.frontend.max_keypoints,
                             domain=domain)
    render_s = time.perf_counter() - t0
    if warmup:
        e2e.run_learned_e2e(sp, lg, scene, cfg, 2 + chunk, chunk=chunk,
                            ba_every=8, device=dev, stack=stack[:2 + chunk],
                            subpix=head)
    diag = {} if diag_out is None else diag_out
    res = e2e.run_learned_e2e(sp, lg, scene, cfg, frames, chunk=chunk,
                              ba_every=8, device=dev, stack=stack,
                              diag_out=diag, subpix=head)
    traj_len = float(frames)          # ~1 m per frame
    return dict(
        config=("flagship: 376x1241, N=2048, D=256, 9-layer matcher, "
                f"LightGlue x{3 if reobs_mode == 'separate' else 2} passes, "
                f"trained flagship weights, subpix={subpix}, "
                f"reobs={reobs_mode}, domain={domain}, "
                f"loop_closing=on, {frames}-frame held-out sequence "
                f"(seed {seed}, {motion}), PyTorch/CUDA port"),
        device=device_line(dev),
        ate_rmse_m=round(res.ate_m, 4),
        ate_pct_of_trajectory=round(100.0 * res.ate_m / traj_len, 3),
        num_keyframes=res.num_keyframes,
        num_frames=res.num_frames,
        num_ba_runs=res.num_ba_runs,
        mean_matches=round(res.mean_matches, 1),
        mean_inliers=round(res.mean_inliers, 1),
        num_rejected_frames=res.num_rejected,
        mean_pose_cost=round(res.mean_pose_cost, 3),
        fps_same_run=round(res.fps, 2),
        loop_closures=res.loop_closures,
        num_recoveries=diag["num_recoveries"],
        render_s=round(render_s, 1),
        **_loop_diag(diag))


def loopclose_ab(ckpt_dir: str, frames: int = 420, period: int = 360,
                 seed: int = 31, chunk: int = 8, ba_every: int = 8,
                 domain: str = "clean", device=None) -> dict:
    """Loop closing off, then on, over a closed-circle revisit
    (`motion="loop"`, one lap per `period` frames, the tail re-traversing
    the first lap) with the flagship front end and pair head: the A/B of
    scripts/eval_loopclose.py at its committed flagship settings."""
    dev = resolve_device(device)
    n = frames
    cfg = flagship_config()
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, max_keyframes=max(512, 1 << (n - 1).bit_length())))
    sp, lg = e2e.load_flagship_frontend(ckpt_dir, device=dev)
    head = e2e.load_flagship_subpix(ckpt_dir, device=dev)
    if head is None:
        raise FileNotFoundError(f"no kspair_flagship.npz in {ckpt_dir}")
    scene = synthetic.make_scene(
        num_landmarks=max(20000, n * 170), num_frames=n,
        height=cfg.frontend.image_height, width=cfg.frontend.image_width,
        desc_dim=cfg.frontend.descriptor_dim, seed=seed, motion="loop",
        loop_period=period)
    stack = e2e.render_stack(scene, n, cfg.frontend.max_keypoints,
                             domain=domain)
    e2e.run_learned_e2e(sp, lg, scene, cfg, 2 + chunk, chunk=chunk,
                        ba_every=ba_every, device=dev,
                        stack=stack[:2 + chunk], subpix=head)   # warm-up
    out = {}
    for name, loop_on in (("loop_off", False), ("loop_on", True)):
        run_cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, loop_closing=loop_on))
        diag = {}
        res = e2e.run_learned_e2e(sp, lg, scene, run_cfg, n, chunk=chunk,
                                  ba_every=ba_every, device=dev,
                                  stack=stack, diag_out=diag, subpix=head)
        out[name] = dict(ate_rmse_m=round(res.ate_m, 4),
                         keyframes=res.num_keyframes, frames=res.num_frames,
                         loop_closures=res.loop_closures,
                         ba_runs=res.num_ba_runs,
                         recoveries=diag["num_recoveries"],
                         mean_matches=round(res.mean_matches, 1),
                         fps=round(res.fps, 2), **_loop_diag(diag))
    off, on = out["loop_off"], out["loop_on"]
    return dict(
        config=(f"loop-closure A/B: {n}-frame closed-circle, period "
                f"{period} (re-traversal tail {n - period} frames), domain "
                f"{domain} (radius ~{period / (2 * np.pi):.0f} m), learned "
                f"flagship front-end with the pair sub-pixel head, chunked "
                f"driver, chunk={chunk}, ba_every={ba_every}, seed {seed}, "
                f"PyTorch/CUDA port"),
        device=device_line(dev),
        loop_off=off, loop_on=on,
        ate_improvement_pct=round(
            100.0 * (off["ate_rmse_m"] - on["ate_rmse_m"])
            / max(off["ate_rmse_m"], 1e-9), 2))

