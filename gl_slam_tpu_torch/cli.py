"""Command-line entry point of the port: `gl-slam-tpu-torch run`.

Counterpart of gl_slam_tpu/cli.py: read a KITTI or EuRoC directory (or
render the built-in synthetic sequence), bootstrap on the first two frames,
track the rest, then write `trajectory.txt` (KITTI rows), `map.json` and
`trajectory.png` (where matplotlib is installed) to `--out` and print one
JSON report with ATE. Every flag of the JAX CLI's `run` keeps its default,
and one more, `--device`, selects the card (default) or the CPU.

Two routes, as in the JAX CLI:

  * chunked (`--frontend superpoint`): the learned tracker in chunks
    through `slam/chunk_driver.ChunkedPipeline` (a partial tail chunk
    padded with copies of its last real frame and gated off);
  * per-frame (`--frontend oracle`, the default, on the synthetic
    sequence; `--frontend harris`; `--frontend superpoint --per-frame`):
    one frame at a time through `slam/pipeline.TrackingPipeline`, frames
    the ground-truth motion gate finds static skipped, with
    `metrics.jsonl`, `--live-viz N` (`<out>/live/live.json`, and
    `live.png` where matplotlib is installed) and `--checkpoint`
    (`<out>/ckpt/state.npz`).

    gl-slam-tpu-torch run --dataset <KITTI root> --frontend superpoint \\
        --preset flagship --first-frame 0 --last-frame 30
    gl-slam-tpu-torch run --dataset <EuRoC dir> --frontend harris

Both routes take every tracker option of the JAX package's configuration
(the PnP tracker, the merged and batched re-observation modes,
motion-gated keyframing).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _native_frames(seq, args):
    """frame(i) of a KITTI sequence through the native prefetch loader
    (runtime/native_lib.py) over frames --first-frame..--last-frame:
    threads decode ahead of the tracker off its loop, and each frame comes
    off the loader's ring once. Frames are asked for in increasing order;
    a frame passed over (the per-frame route's gated frames) is dropped.
    A frame that does not decode, or one asked for twice, raises."""
    from .io.kitti import frame_path
    from .runtime.native_lib import NativeLoader
    first = args.first_frame
    paths = [frame_path(seq.seq_dir, i, seq.camera_dir)
             for i in range(first, args.last_frame + 1)]
    frames = iter(NativeLoader(paths, args.height, args.width, depth=4,
                               threads=2))

    def frame(i):
        for j, img in frames:
            if first + j == i:
                return img
            if first + j > i:
                break
        raise RuntimeError(f"native loader: frame {i} did not decode or "
                           f"was asked for twice")

    return frame


def _open_dataset(args):
    """-> (source, K, gt_R, gt_t, frame_fn, gt_motion_small_fn): the
    synthetic scene, an EuRoC directory (a `mav0/` inside) or a KITTI
    odometry root. Frames are cropped to --height x --width. A KITTI
    sequence is read through the native PNG prefetch loader where it is
    built (`native_lib.available()`), else with PIL, as in the JAX CLI."""
    H, W = args.height, args.width
    if args.dataset == "synthetic":
        from .io import synthetic
        scene = synthetic.make_scene(
            num_landmarks=args.landmarks, num_frames=args.last_frame + 1,
            height=H, width=W, desc_dim=args.desc_dim, seed=args.scene_seed)

        def frame(i):
            return synthetic.render_frame(scene, i, max_keypoints=args.kpts)

        return scene, scene.K, scene.poses_R, scene.poses_t, frame, None

    if os.path.isdir(os.path.join(args.dataset, "mav0")):
        from .io.euroc import EurocSequence
        seq = EurocSequence(args.dataset)
    else:
        from .io.kitti import KittiSequence
        from .runtime import native_lib
        seq = KittiSequence(args.dataset, args.sequence)
        if native_lib.available():
            return (seq, seq.K, seq.gt_R, seq.gt_t,
                    _native_frames(seq, args), seq.gt_motion_small)

    def frame(i):
        return seq.frame(i)[:H, :W]

    return seq, seq.K, seq.gt_R, seq.gt_t, frame, seq.gt_motion_small


def _run_chunked(args) -> int:
    """The learned route: bootstrap, a warm-up chunk outside the timed
    region, whole chunks, then the padded and gated tail chunk. The report
    has the keys of the JAX CLI's chunked report, with their meaning:
    `frames_fed` counts the real frames, `frames_tracked` the trajectory's
    rows (keyframes), `frames_rejected` the frames not accepted, the gated
    padding included, and `mean_matches` is over every tracked step.
    `stages`, not in the JAX report, has the host time of each top-level
    span (bootstrap, warm-up, chunk, BA pass, loop closing) in the
    format of the per-frame route's."""
    from . import metrics as metrics_mod
    from . import tracing
    from .checkpoint import export_kitti_trajectory
    from .config import flagship_config, micro_config
    from .device import resolve_device
    from .slam.chunk_driver import ChunkedPipeline
    from .train import e2e
    from .viz.viewer import MapSnapshot, render_topdown

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    flag = args.preset == "flagship"
    if flag:
        sp, lg = e2e.load_flagship_frontend(args.weights, device=dev)
        cfg = flagship_config(args.height, args.width)
    else:
        sp, lg = e2e.load_tiny_frontend(args.weights, device=dev)
        cfg = micro_config(args.height, args.width, args.kpts, args.desc_dim)
    subpix_mode = args.subpix or "pair"
    head = None
    if subpix_mode != "centroid":
        loader = e2e.load_flagship_subpix if flag else e2e.load_tiny_subpix
        head = loader(args.weights, pair=subpix_mode == "pair", device=dev)
        if head is None:
            subpix_mode = "centroid"

    _, K, gt_R, gt_t, frame_fn, _ = _open_dataset(args)
    pipe = ChunkedPipeline(cfg, K, sp, lg, chunk=args.chunk,
                           ba_every=args.ba_every, subpix_head=head,
                           device=dev)

    first, last = args.first_frame, args.last_frame
    gt_scale = 1.0
    if gt_R is not None and cfg.runtime.use_gt_scale:
        c0 = -gt_R[first].T @ gt_t[first]
        c1 = -gt_R[first + 1].T @ gt_t[first + 1]
        gt_scale = float(np.linalg.norm(c1 - c0))

    def chunk_images(i0, n=None):
        # n < chunk: the tail chunk, padded with copies of its last real
        # frame (gated off below); each real frame is read once
        n = args.chunk if n is None else n
        real = [np.asarray(frame_fn(i0 + t), dtype=np.float32)
                for t in range(n)]
        return np.stack(real + [real[-1]] * (args.chunk - n))

    with tracing.recording(syncs=False) as rec:
        with tracing.span("bootstrap"):
            pipe.bootstrap_from_images(frame_fn(first), frame_fn(first + 1),
                                       gt_scale, frame_idx0=first)
        i = first + 2
        warm = None
        if i + args.chunk <= last + 1:
            warm = chunk_images(i)
            with tracing.span("warmup"):
                pipe.warmup(warm)
        t_start = time.time()
        while i + args.chunk <= last + 1:
            imgs = warm if (warm is not None and i == first + 2) \
                else chunk_images(i)
            pipe.track_chunk(imgs, i)
            i += args.chunk
        n_tail = last + 1 - i
        if n_tail > 0:
            gate = np.arange(args.chunk) < n_tail
            pipe.track_chunk(chunk_images(i, n_tail), i, frame_gate=gate)
            i += n_tail
        pipe.finish()
        elapsed = time.time() - t_start

    R, t, fidx = pipe.trajectory()
    export_kitti_trajectory(os.path.join(args.out, "trajectory.txt"), R, t)
    snap = MapSnapshot(pipe.state.map)
    snap.to_json(os.path.join(args.out, "map.json"))
    outs = pipe.stacked_outputs()
    report = {
        "frontend": "superpoint-chunked",
        "preset": args.preset,
        "subpix": subpix_mode,
        "frames_fed": i - first,
        "frames_tracked": int(len(R)),
        "frames_rejected": int((~outs.frame_ok).sum()) if outs is not None
        else 0,
        "fps_incl_io": round((i - first) / elapsed, 2),
        "ba_runs": pipe.num_ba_runs,
        "loop_closures": pipe.num_loop_closures,
        "mean_matches": float(np.mean(outs.num_matches)) if outs is not None
        else 0.0,
        "stages": rec.stages(),
    }
    c_gt = None
    if gt_R is not None:
        c_est = metrics_mod.camera_centers(R, t)
        c_gt = metrics_mod.camera_centers(gt_R[fidx], gt_t[fidx])
        report["ate_rmse_m"] = round(
            metrics_mod.ate_rmse(c_est, c_gt, align=False), 4)
    render_topdown(snap, os.path.join(args.out, "trajectory.png"),
                   gt_centers=c_gt)
    print(json.dumps(report, indent=2))
    return 0


def _build_config(args, reobs_matcher: str):
    """The per-frame route's configuration, from the flags."""
    from .config import (BAConfig, FrontendConfig, GeometryConfig, MapConfig,
                         RuntimeConfig, SLAMConfig)
    return SLAMConfig(
        frontend=FrontendConfig(
            image_height=args.height, image_width=args.width,
            max_keypoints=args.kpts, descriptor_dim=args.desc_dim,
            match_threshold=args.match_thr,
            map_match_threshold=args.match_thr,
            score_threshold=args.score_thr, nms_radius=args.nms_radius,
            reobs_matcher=reobs_matcher),
        geometry=GeometryConfig(
            essential_hypotheses=args.hypotheses,
            essential_threshold_px=args.essential_thr,
            triangulation_reproj_px=args.tri_thr,
            triangulation_reproj_bootstrap_px=max(args.tri_thr, 0.5),
            max_depth=args.max_depth),
        ba=BAConfig(max_window_cameras=16, max_window_points=args.ba_points,
                    full_ba_iters=args.ba_iters,
                    pose_only_iters=args.pose_iters, full_ba_overlap=4),
        map=MapConfig(max_keyframes=args.max_keyframes,
                      max_points=args.max_points,
                      covis_max_points=min(args.kpts, 2048),
                      covis_edge_threshold=args.covis_thr,
                      cull_enabled=not args.no_cull),
        runtime=RuntimeConfig(use_gt_scale=not args.no_gt_scale,
                              use_gt_motion_gate=not args.no_gt_gate,
                              ba_trigger_keyframes=args.ba_trigger,
                              async_ba=not args.sync_ba),
    )


def _per_frame_features(args, cfg, src, frame_fn, dev):
    """(features(i) -> (kpts, desc, valid), matcher or None) of the
    per-frame front end: the oracle's projected landmarks (synthetic
    sequence only), Harris corners with patch descriptors, or the learned
    extractor at batch 1 (SuperPointNet, NMS, centroid refinement,
    descriptor sampling) with LightGlue and the fused assignment as the
    matcher of all three passes."""
    import torch
    from . import tracing
    from .device import upload

    def image(i):
        return upload(np.asarray(frame_fn(i), dtype=np.float32),
                      torch.float32, dev)

    if args.frontend == "oracle":
        if args.dataset != "synthetic":
            raise SystemExit("--frontend oracle needs --dataset synthetic")
        from .io import synthetic

        def features(i):
            o = synthetic.observe_frame(src, i, max_keypoints=args.kpts,
                                        noise_px=args.noise, seed=13)
            return o.keypoints, o.descriptors, o.valid
        return features, None
    if args.frontend == "harris":
        from .models.classical import HarrisExtractor
        ex = HarrisExtractor(args.height, args.width,
                             max_keypoints=args.kpts)

        def features(i):
            kpts, _, desc, valid = ex(image(i)[None])
            return kpts[0], desc[0], valid[0]
        return features, None
    from .slam import fused
    from .train import e2e
    load = e2e.load_flagship_frontend if args.preset == "flagship" \
        else e2e.load_tiny_frontend
    sp, lg = load(args.weights, device=dev)
    extract = fused.build_extract_fn(cfg, sp)

    @torch.no_grad()
    def features(i):
        with tracing.span("extract"):
            kpts, desc, valid = extract(image(i)[None])
        return kpts[0], desc[0], valid[0]
    return features, fused.build_matcher(cfg, lg)


def _run_per_frame(args) -> int:
    """The per-frame route: the bootstrap on the first two frames, then one
    `TrackingPipeline.step` per frame the ground-truth motion gate lets
    through. The report has the keys of the JAX CLI's per-frame report:
    `frames_tracked` counts the trajectory's rows (keyframes),
    `frames_gated` the frames the gate skipped, `fps_incl_features` the
    keyframes over the host wall time of the whole run, feature extraction
    included."""
    from . import metrics as metrics_mod
    from .checkpoint import export_kitti_trajectory, save_state
    from .device import resolve_device
    from .slam.pipeline import TrackingPipeline
    from . import tracing
    from .viz.viewer import LiveViewer, MapSnapshot, render_topdown

    dev = resolve_device(args.device)
    reobs = "lightglue" if args.frontend == "superpoint" else "mutual_nn"
    cfg = _build_config(args, reobs)
    src, K, gt_R, gt_t, frame_fn, gate_fn = _open_dataset(args)
    features, matcher = _per_frame_features(args, cfg, src, frame_fn, dev)
    os.makedirs(args.out, exist_ok=True)

    pipe = TrackingPipeline(cfg, K, matcher=matcher, device=dev)
    rec = tracing.MetricsRecorder()
    live = None
    if args.live_viz > 0:
        live = LiveViewer(os.path.join(args.out, "live"),
                          every=args.live_viz)

    first, last = args.first_frame, args.last_frame
    gt_scale = 1.0
    if gt_R is not None and cfg.runtime.use_gt_scale:
        c0 = -gt_R[first].T @ gt_t[first]
        c1 = -gt_R[first + 1].T @ gt_t[first + 1]
        gt_scale = float(np.linalg.norm(c1 - c0))

    with tracing.recording(syncs=False) as spans:
        t_start = time.time()
        f0, f1 = features(first), features(first + 1)
        with tracing.span("bootstrap"):
            pipe.bootstrap((*f0, first), (*f1, first + 1), gt_scale=gt_scale)
        prev_idx = first + 1
        n_gated = 0
        steps = []
        for i in range(first + 2, last + 1):
            # ground-truth motion gate: skip near-static frames
            if (cfg.runtime.use_gt_motion_gate and gate_fn is not None
                    and gt_R is not None
                    and gate_fn(prev_idx, i, cfg.runtime.gt_mag_filter,
                                cfg.runtime.gt_rot_filter)):
                n_gated += 1
                continue
            prev_idx = i
            with tracing.span("features"):
                f = features(i)
            with tracing.span("track"):
                steps.append((i, pipe.step(*f, i)))
            if live is not None:
                live.update(pipe.state.map, i)
        pipe.finish()
        if live is not None:
            live.close()
        elapsed = time.time() - t_start

    for i, out in steps:
        rec.record(i, num_matches=out.num_matches,
                   num_map_matches=out.num_map_matches,
                   num_new_points=out.num_new_points)
    R, t, fidx = pipe.trajectory()
    export_kitti_trajectory(os.path.join(args.out, "trajectory.txt"), R, t)
    rec.to_jsonl(os.path.join(args.out, "metrics.jsonl"))
    snap = MapSnapshot(pipe.state.map)
    snap.to_json(os.path.join(args.out, "map.json"))

    report = {
        "frontend": args.frontend,
        "frames_tracked": int(len(R)),
        "frames_gated": n_gated,
        "fps_incl_features": round(len(R) / elapsed, 2),
        "map": pipe.map_stats(),
        "stages": spans.stages(("bootstrap", "features", "track")),
    }
    c_gt = None
    if gt_R is not None:
        errs = metrics_mod.per_frame_pose_errors(R, t, gt_R[fidx],
                                                 gt_t[fidx])
        c_est = metrics_mod.camera_centers(R, t)
        c_gt = metrics_mod.camera_centers(gt_R[fidx], gt_t[fidx])
        report["ate_rmse_m"] = round(
            metrics_mod.ate_rmse(c_est, c_gt, align=False), 4)
        report["ate_rmse_aligned_m"] = round(
            metrics_mod.ate_rmse(c_est, c_gt, align=True), 4)
        report["rot_err_deg_max"] = round(float(errs.rot_deg.max()), 4)
    render_topdown(snap, os.path.join(args.out, "trajectory.png"),
                   gt_centers=c_gt)
    if args.checkpoint:
        save_state(os.path.join(args.out, "ckpt"), pipe.state)
    print(json.dumps(report, indent=2))
    return 0


def cmd_run(args) -> int:
    if args.frontend == "superpoint" and not args.per_frame:
        return _run_chunked(args)
    return _run_per_frame(args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gl-slam-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run SLAM over a sequence")
    run.add_argument("--dataset", default="synthetic",
                     help="'synthetic', a KITTI odometry root or an EuRoC "
                          "sequence directory (with mav0/)")
    run.add_argument("--sequence", default="00")
    run.add_argument("--frontend", default="oracle",
                     choices=["oracle", "harris", "superpoint"])
    run.add_argument("--weights", default="checkpoints",
                     help="directory with sp_/lg_ .npz (superpoint mode)")
    run.add_argument("--preset", default="tiny",
                     choices=["tiny", "flagship"])
    run.add_argument("--out", default="out")
    run.add_argument("--first-frame", type=int, default=0)
    run.add_argument("--last-frame", type=int, default=40)
    # None = resolved from --preset (tiny: 240x320 N=512 D=64; flagship:
    # 376x1241 N=2048 D=256)
    run.add_argument("--height", type=int, default=None)
    run.add_argument("--width", type=int, default=None)
    run.add_argument("--kpts", type=int, default=None)
    run.add_argument("--desc-dim", type=int, default=None)
    run.add_argument("--landmarks", type=int, default=4000)
    run.add_argument("--scene-seed", type=int, default=7)
    run.add_argument("--noise", type=float, default=0.2)
    run.add_argument("--match-thr", type=float, default=0.7)
    run.add_argument("--score-thr", type=float, default=0.02)
    run.add_argument("--nms-radius", type=int, default=3)
    run.add_argument("--essential-thr", type=float, default=0.5)
    run.add_argument("--tri-thr", type=float, default=0.5)
    run.add_argument("--max-depth", type=float, default=100.0)
    run.add_argument("--hypotheses", type=int, default=256)
    run.add_argument("--ba-iters", type=int, default=30)
    run.add_argument("--pose-iters", type=int, default=30)
    run.add_argument("--ba-points", type=int, default=4096)
    run.add_argument("--ba-trigger", type=int, default=7)
    run.add_argument("--covis-thr", type=int, default=50)
    run.add_argument("--max-keyframes", type=int, default=256)
    run.add_argument("--max-points", type=int, default=65536)
    run.add_argument("--no-cull", action="store_true")
    run.add_argument("--no-gt-scale", action="store_true")
    run.add_argument("--no-gt-gate", action="store_true")
    run.add_argument("--sync-ba", action="store_true")
    run.add_argument("--checkpoint", action="store_true")
    run.add_argument("--live-viz", type=int, default=0, metavar="N",
                     help="stream live.{json,png} to <out>/live every N "
                          "frames (0 = off)")
    run.add_argument("--per-frame", action="store_true",
                     help="superpoint front-end: use the per-frame "
                          "TrackingPipeline instead of the chunked route")
    run.add_argument("--chunk", type=int, default=8,
                     help="frames per chunk (chunked route)")
    run.add_argument("--ba-every", type=int, default=8,
                     help="frames between window-BA passes (chunked route)")
    run.add_argument("--subpix", default=None,
                     choices=["pair", "single", "centroid"],
                     help="sub-pixel refinement for the chunked route "
                          "(default: pair when a kspair checkpoint exists)")
    run.add_argument("--device", default=None,
                     help="default: the CUDA card; 'cpu' to run on the CPU")
    run.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    flag = args.preset == "flagship"
    for name, tiny_v, flag_v in (("height", 240, 376), ("width", 320, 1241),
                                 ("kpts", 512, 2048), ("desc_dim", 64, 256)):
        if getattr(args, name) is None:
            setattr(args, name, flag_v if flag else tiny_v)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
