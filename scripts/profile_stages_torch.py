"""Per-stage timing of the port's tracked-frame pipeline on the card (the
counterpart of scripts/profile_stages.py).

Times each stage of the tracked frame alone at flagship shapes (376x1241,
N=2048, D=256, the committed flagship networks) to locate the per-frame
cost, on the stages of `profile_stages.py` under the same names: the
SuperPoint CNN, NMS+topK through the NMS kernel ("pallas", the JAX name of
the hand-written kernel) and through `nms_plain` ("xla"), centroid
refinement and descriptor sampling, the learned matcher (LightGlue 9
layers through the attention kernel, then the assignment kernel) at 2048 x
2048, mutual-NN matching, the essential RANSAC (512 hypotheses), the pose
LM (30 iterations), triangulation, `insert_keyframe`, both re-observation
passes and `track_step` on oracle features (on an empty map, as there),
and a window BA pass (<= 12 keyframes, LM30) on a map bootstrapped and
tracked over 8 frames.

Per stage:
  host_ms    host time a call: a block of calls timed by `perf_counter`
             with a synchronisation after the last, n calls or as many as
             fill 0.25 s (calls_a_block), so that a short stage is not
             timed over a few ms that one interruption can swell; the
             fastest of 9 such blocks, taken in rounds that time every
             stage once each, so that a slow spell of the shared host
             falls on one block of many stages, not on every block of one
             (all nine in host_blocks_ms);
  device_ms  device time a call: CUDA events around n calls queued behind
             a spin kernel (chip_smoke.time_ms); where the host issues the
             calls slower than the device runs them, this includes the
             device's idle gaps and nears host_ms;
  busy_ms    the device activities' summed time in one call
             (torch.profiler), with the three longest in top_device;
  launches   the kernel launch calls one call makes (torch.profiler).
On the CPU (`--device cpu`) only host_ms is measured; the others are None.

`--json PATH` writes {"backend", "card", "stages_ms": {name: host_ms},
"stages": {name: {...}}}; `stages_ms` keeps profile_stages.py's format,
and scripts/bench_diff_torch.py compares it with PERF_BASELINE_TORCH.json.

    python3 scripts/profile_stages_torch.py --json PERF_BASELINE_TORCH.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

H, W, N, D = 376, 1241, 2048, 256
BLOCKS = 9
MIN_BLOCK_S = 0.25
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


@contextlib.contextmanager
def plain_nms():
    """`ops/nms.detect_keypoints` through `nms_plain` on any device."""
    from gl_slam_tpu_torch.ops import nms as nms_ops
    kernel = nms_ops.nms
    nms_ops.nms = nms_ops.nms_plain
    try:
        yield
    finally:
        nms_ops.nms = kernel


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profile_one(fn):
    """(kernel launch calls, summed device ms, the three device activities
    with the most time as [name, ms, count]) of one call of fn. The sum
    counts every device activity (kernels, copies, fills) by its own
    duration, so activities that overlap on several streams count
    twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    launches, busy_ns, by_name = 0, 0, {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():      # the stage markers' device spans
            continue
        if e.device_type() == cuda:
            busy_ns += e.duration_ns()
            t, c = by_name.get(e.name()[:80], (0, 0))
            by_name[e.name()[:80]] = (t + e.duration_ns(), c + 1)
        elif e.name() in LAUNCH_CALLS:
            launches += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:3]
    return launches, busy_ns / 1e6, [[k, t / 1e6, c] for k, (t, c) in top]


def measure(stages: list, dev) -> dict:
    """Time every (name, fn, calls) of `stages` as the module docstring
    says -> {name: row}: two warm-up calls of each (the second timed, to
    size its blocks), then BLOCKS rounds, each timing one block of every
    stage in turn; then, on a card, the device time over `calls` calls and
    one profiled call of each."""
    import torch
    with torch.no_grad():
        per_block = {}
        for name, fn, calls in stages:
            fn()
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            one = time.perf_counter() - t0
            per_block[name] = max(calls, math.ceil(MIN_BLOCK_S / one))
        blocks = {name: [] for name, _, _ in stages}
        for _ in range(BLOCKS):
            for name, fn, _ in stages:
                k = per_block[name]
                t0 = time.perf_counter()
                for _ in range(k):
                    fn()
                _sync(dev)
                blocks[name].append((time.perf_counter() - t0) / k * 1e3)
        out = {}
        for name, fn, calls in stages:
            row = dict(host_ms=min(blocks[name]),
                       host_blocks_ms=blocks[name],
                       calls_a_block=per_block[name], device_ms=None,
                       busy_ms=None, launches=None, top_device=None)
            if dev.type == "cuda":
                import chip_smoke
                row["device_ms"] = chip_smoke.time_ms(fn, reps=calls,
                                                      warmup=0)
                row["launches"], row["busy_ms"], row["top_device"] = \
                    _profile_one(fn)
            out[name] = row
            dev_txt = "" if row["device_ms"] is None else (
                f", device {row['device_ms']:8.3f} ms, busy "
                f"{row['busy_ms']:8.3f} ms, {row['launches']} launches")
            print(f"{name:>28}: host {row['host_ms']:8.3f} ms{dev_txt}",
                  flush=True)
    return out


def run_stages(dev, sp, lg, n: int = 10, height: int = H, width: int = W,
               max_kpts: int = N, desc_dim: int = D, landmarks: int = 3000,
               ba_n: int = 5) -> dict:
    """Every stage at the given shapes (flagship by default) -> {name:
    row}, under profile_stages.py's names whatever the shapes. `sp` /
    `lg`: the networks (SuperPointNet, LightGlueNet) on `dev`."""
    import torch

    from gl_slam_tpu_torch.config import (BAConfig, FrontendConfig,
                                          MapConfig, SLAMConfig)
    from gl_slam_tpu_torch.geometry import essential, triangulation
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.models.subpix import centroid_refine
    from gl_slam_tpu_torch.models.superpoint import sample_descriptors
    from gl_slam_tpu_torch.ops import match as match_ops
    from gl_slam_tpu_torch.ops import nms as nms_ops
    from gl_slam_tpu_torch.slam import ba as ba_mod
    from gl_slam_tpu_torch.slam import frontend, fused, pose_ba, reobserve
    from gl_slam_tpu_torch.slam.state import insert_keyframe

    Hh, Ww, Nk, Dd = height, width, max_kpts, desc_dim
    pad_h, pad_w = (-Hh) % 8, (-Ww) % 8
    cfg = SLAMConfig(
        frontend=FrontendConfig(image_height=Hh, image_width=Ww,
                                max_keypoints=Nk, descriptor_dim=Dd),
        map=MapConfig(max_keyframes=512, max_points=65536))
    scene = synthetic.make_scene(num_landmarks=landmarks, num_frames=3,
                                 height=Hh, width=Ww, desc_dim=Dd, seed=0)
    f32 = dict(dtype=torch.float32, device=dev)
    obs = [synthetic.observe_frame(scene, i, max_keypoints=Nk)
           for i in range(3)]
    K = torch.as_tensor(scene.K, **f32)
    img = torch.as_tensor(synthetic.render_frame(scene, 1,
                                                 max_keypoints=Nk), **f32)
    gen = torch.Generator(device=dev).manual_seed(1)
    eye, zeros = torch.eye(3, **f32), torch.zeros(3, **f32)
    none = torch.full((Nk,), -1, dtype=torch.int32, device=dev)
    stages = []

    def stage(name, fn, calls=n):
        stages.append((name, fn, calls))

    def feats(o, i):
        return frontend.FrameFeatures(
            kpts=torch.as_tensor(o.keypoints, **f32),
            desc=torch.as_tensor(o.descriptors, **f32),
            valid=torch.as_tensor(o.valid, device=dev),
            frame_idx=torch.tensor(i, dtype=torch.int32, device=dev))

    # the SuperPoint CNN on the padded image
    x = torch.nn.functional.pad(img[None], (0, pad_w, 0, pad_h))[..., None]
    with torch.no_grad():
        heat, grid = sp(x)
    stage("superpoint CNN", lambda: sp(x))

    # NMS + top-K: the kernel, then the plain version
    heat32 = heat.float()
    stage("NMS+topK (pallas)", lambda: nms_ops.detect_keypoints(
        heat32, Nk, 0.0005, 4))

    def detect_plain():
        with plain_nms():
            return nms_ops.detect_keypoints(heat32, Nk, 0.0005, 4)

    stage("NMS+topK (xla)", detect_plain)
    kp, _, valid = nms_ops.detect_keypoints(heat32, Nk, 0.0005, 4)
    kp, valid = kp[0].float(), valid[0]

    # sub-pixel refinement and descriptor sampling
    stage("centroid refine", lambda: centroid_refine(heat32[0], kp, 5))
    stage("desc sampling", lambda: sample_descriptors(grid[0], kp))

    # the learned matcher and mutual NN
    desc = sample_descriptors(grid[0], kp)
    matcher = fused.build_matcher(cfg, lg)
    stage("lightglue 9L@2048",
          lambda: matcher(kp, desc, valid, kp, desc, valid))
    stage("mutual NN match", lambda: match_ops.mutual_nn_match(
        desc, valid, desc, valid))

    # two-view and pose geometry on the oracle observations of frames 0-1
    f0, f1 = feats(obs[0], 0), feats(obs[1], 1)
    mask = f0.valid
    u512 = torch.rand((512, 8), generator=gen, device=dev)
    stage("essential RANSAC 512", lambda: essential.estimate_essential(
        K, f0.kpts, f1.kpts, mask, u512, threshold_px=0.5,
        num_hypotheses=512, refine_iters=10))
    pts = torch.as_tensor(scene.landmarks[obs[1].landmark_ids.clip(0)],
                          **f32)
    stage("pose-only LM30", lambda: pose_ba.pose_only_ba(
        K, eye, zeros, pts, f1.kpts, mask, iters=30))
    ones = torch.ones(3, **f32)
    stage("triangulate 2048", lambda: triangulation.triangulate(
        K, eye, zeros, eye, ones, f0.kpts, f1.kpts, mask))

    # the map stages on an empty map, previous features of frame 0
    state = frontend.init_track_state(cfg, device=dev)
    state = state._replace(prev_kpts=f0.kpts, prev_desc=f0.desc,
                           prev_valid=f0.valid)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    stage("insert_keyframe", lambda: insert_keyframe(
        state.map, eye, zeros, f1.frame_idx, f1.kpts, f1.desc, f1.valid,
        none, torch.zeros((Nk, 3), **f32),
        torch.zeros((Nk,), dtype=torch.bool, device=dev), none, none,
        zero_i))
    stage("map window reobs", lambda: reobserve.match_map_window(
        cfg, K, state.map, eye, zeros, f1))
    stage("covis retrieval", lambda: reobserve.match_covisible(
        cfg, K, state.map, eye, zeros, f1, none, none))
    u = torch.rand((cfg.geometry.essential_hypotheses, 8), generator=gen,
                   device=dev)
    stage("track_step (oracle)", lambda: frontend.track_step(
        cfg, K, state, f1, u))

    # the window BA at bench shapes on a bootstrapped, tracked map
    cfg_ba = dataclasses.replace(cfg, ba=BAConfig(
        max_window_cameras=12, max_window_points=2048, full_ba_overlap=3))
    with torch.no_grad():
        st2 = frontend.bootstrap_step(
            cfg_ba, K, state, f0, f1, torch.tensor(1.0, **f32), u=u)[0]
        for i in range(2, 10):
            st2 = frontend.track_step(cfg_ba, K, st2,
                                      feats(obs[min(i, 2)], i), u)[0]
    stage("ba_step win<=12 LM30", lambda: ba_mod.ba_step(
        cfg_ba, K, st2.map, 0, 10), calls=ba_n)
    return measure(stages, dev)


def report(stages: dict, card: str, backend: str) -> dict:
    return {"backend": backend, "card": card,
            "stages_ms": {k: round(v["host_ms"], 3)
                          for k, v in stages.items()},
            "stages": stages}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write the table here")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without CUDA)")
    args = ap.parse_args(argv)

    from gl_slam_tpu_torch.device import resolve_device
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.train import e2e
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import chip_smoke
        card = chip_smoke.card_line()
        _build.build_all()
    else:
        card = "cpu"
    print(f"card: {card}", flush=True)
    sp, lg = e2e.load_flagship_frontend(os.path.join(ROOT, "checkpoints"),
                                        device=dev)
    stages = run_stages(dev, sp, lg)
    rep = report(stages, card, dev.type)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
