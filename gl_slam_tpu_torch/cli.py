"""Command-line entry point of the port: `gl-slam-tpu-torch run`.

Counterpart of gl_slam_tpu/cli.py on its chunked learned route
(`--frontend superpoint`, the default sub-pixel mode pair): read a KITTI or
EuRoC directory (or render the built-in synthetic sequence), bootstrap on
the first two frames, track the rest in chunks through
`slam/chunk_driver.ChunkedPipeline` (a partial tail chunk padded with
copies of its last real frame and gated off), then write `trajectory.txt`
(KITTI rows), `map.json` and `trajectory.png` (where matplotlib is
installed) to `--out` and print one JSON report with ATE. Every flag of the
JAX CLI's `run` keeps its default, and one more, `--device`, selects the
card (default) or the CPU:

    gl-slam-tpu-torch run --dataset <KITTI root> --frontend superpoint \\
        --preset flagship --first-frame 0 --last-frame 30

The per-frame route (`--frontend oracle|harris`, `--per-frame`) is not
ported yet and raises; see ROADMAP.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _open_dataset(args):
    """-> (source, K, gt_R, gt_t, frame_fn, gt_motion_small_fn): the
    synthetic scene, an EuRoC directory (a `mav0/` inside) or a KITTI
    odometry root. Frames are cropped to --height x --width."""
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
        seq = KittiSequence(args.dataset, args.sequence)

    def frame(i):
        return seq.frame(i)[:H, :W]

    return seq, seq.K, seq.gt_R, seq.gt_t, frame, seq.gt_motion_small


def _run_chunked(args) -> int:
    """The learned route: bootstrap, a warm-up chunk outside the timed
    region, whole chunks, then the padded and gated tail chunk. The report
    has the keys of the JAX CLI's chunked report, with their meaning:
    `frames_fed` counts the real frames, `frames_tracked` the trajectory's
    rows (keyframes), `frames_rejected` the frames not accepted, the gated
    padding included, and `mean_matches` is over every tracked step."""
    from . import metrics as metrics_mod
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

    pipe.bootstrap_from_images(frame_fn(first), frame_fn(first + 1),
                               gt_scale, frame_idx0=first)

    def chunk_images(i0, n=None):
        # n < chunk: the tail chunk, padded with copies of its last real
        # frame (gated off below); each real frame is read once
        n = args.chunk if n is None else n
        real = [np.asarray(frame_fn(i0 + t), dtype=np.float32)
                for t in range(n)]
        return np.stack(real + [real[-1]] * (args.chunk - n))

    i = first + 2
    warm = None
    if i + args.chunk <= last + 1:
        warm = chunk_images(i)
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


def cmd_run(args) -> int:
    if args.frontend == "superpoint" and not args.per_frame:
        return _run_chunked(args)
    raise NotImplementedError(
        f"the per-frame route (--frontend {args.frontend}"
        f"{', --per-frame' if args.per_frame else ''}) is not ported yet; "
        "only the chunked learned route (--frontend superpoint) is; see "
        "ROADMAP.md")


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
                          "TrackingPipeline instead of the chunked route "
                          "(not ported yet)")
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
