"""Long-run learned-pipeline harness on the PyTorch/CUDA port: ATE, fps,
BA count and point-table turnover in one JSON.

Counterpart of scripts/longrun_learned.py, flag for flag, with the same
scene, the same configuration edits and the same report keys: it tracks a
long rendered synthetic sequence through the chunked learned pipeline
(SuperPoint extraction, LightGlue on all three matching passes, essential
RANSAC, pose-only LM, triangulation, map insertion with slot recycling,
periodic window BA, loop closing). `--device` picks the device (default:
the card). The report adds the card's name and power limit (`card`), the
run's wall time (`wall_s`, rendering included), the peak device memory
allocated (`peak_allocated_gb`), the loop detections run
(`loop_detections`) and the per-segment lines below (`segments`).

Every 100 frames it prints, before the JSON line: the frames tracked so
far, the tracked fps over that segment, the live map points and the free
point slots (fresh plus the recycling stack) -- whether the per-frame cost
grows with the keyframe count, and whether the table turns over.

  python scripts/longrun_learned_torch.py --preset flagship --frames 1000 \\
      --out LONGRUN_TORCH.json
  python scripts/longrun_learned_torch.py --frames 34 --max-points 1024 \\
      --device cpu
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--preset", choices=["tiny", "flagship"],
                    default="tiny",
                    help="flagship = the full reference-shape pipeline "
                    "(376x1241, N=2048, 9-layer matcher, pair subpix)")
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--kpts", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--ba-every", type=int, default=5)
    ap.add_argument("--weights", default=os.path.join(ROOT, "checkpoints"))
    ap.add_argument("--scene-seed", type=int, default=11)
    ap.add_argument("--reobs", choices=["lightglue", "nn"],
                    default="lightglue",
                    help="matcher for the 2nd/3rd per-frame passes "
                    "(tiny preset; nn = mutual-NN)")
    ap.add_argument("--max-points", type=int, default=0,
                    help="pin the point-table capacity (0 = the script's "
                    "default: 65536 flagship, grown with the sequence "
                    "tiny); a small table must turn over through slot "
                    "recycling (state.recycle_free_slots)")
    ap.add_argument("--out", default="",
                    help="also write the JSON report to this path")
    ap.add_argument("--no-loopclose", action="store_true",
                    help="disable the periodic loop-closure hook")
    ap.add_argument("--scene-frames", type=int, default=0,
                    help="build the scene (and render cache) at this many "
                    "frames while tracking only --frames of them "
                    "(flagship preset)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                    "on the CPU)")
    return ap.parse_args(argv)


def setup(args):
    """(sp, lg, subpix, scene, cfg, run keyword arguments) of a preset:
    scripts/longrun_learned.py's scene and configuration edits."""
    from gl_slam_tpu_torch.config import MapConfig
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.train import e2e

    n = args.frames
    if args.preset == "flagship":
        sp, lg = e2e.load_flagship_frontend(args.weights, device=args.device)
        subpix = e2e.load_flagship_subpix(args.weights, pair=True,
                                          device=args.device)
        cfg = e2e.flagship_config()
        H, W = cfg.frontend.image_height, cfg.frontend.image_width
        D = cfg.frontend.descriptor_dim
        # the 120-frame flagship eval's landmark density per metre (20000
        # over ~120 m), the point table pinned to force slot turnover
        ns = max(args.scene_frames, n)
        scene = synthetic.make_scene(
            num_landmarks=max(20000, ns * 170), num_frames=ns,
            height=H, width=W, desc_dim=D, seed=args.scene_seed,
            motion="forward_turn_band")
        cfg = dataclasses.replace(cfg, map=dataclasses.replace(
            cfg.map, max_keyframes=max(512, 1 << (n - 1).bit_length()),
            max_points=args.max_points or 65536))
        if args.no_loopclose:
            cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
                cfg.runtime, loop_closing=False))
        cache = os.path.join(tempfile.gettempdir(),
                             f"render_flag_{args.scene_seed}_{ns}_{H}x{W}"
                             f"_band.npy")
        run = dict(chunk=args.chunk, ba_every=max(args.ba_every, 8),
                   warmup=True, render_cache=cache)
        return sp, lg, subpix, scene, cfg, run

    sp, lg = e2e.load_tiny_frontend(args.weights, device=args.device)
    H, W, N = args.height, args.width, args.kpts
    D = e2e.TINY_DESC_DIM
    # ~16 landmarks per metre of corridor and a 60 m depth gate, as the
    # JAX script's tiny branch
    scene = synthetic.make_scene(
        num_landmarks=max(1500, (n + 120) * 16), num_frames=n,
        height=H, width=W, desc_dim=D, seed=args.scene_seed, min_depth=4.0)
    cfg = e2e.micro_config(H, W, N, D)
    cfg = dataclasses.replace(
        cfg,
        geometry=dataclasses.replace(cfg.geometry, max_depth=60.0),
        map=MapConfig(
            max_keyframes=max(128, 1 << (n - 1).bit_length()),
            max_points=args.max_points or max(16384, n * 96),
            covis_max_points=512, covis_edge_threshold=10))
    if args.reobs == "nn":
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, reobs_matcher="mutual_nn"))
    if args.no_loopclose:
        cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, loop_closing=False))
    return sp, lg, None, scene, cfg, dict(chunk=args.chunk,
                                          ba_every=args.ba_every)


class Segments:
    """Every `every` frames: the frames tracked, the tracked fps since the
    last line, the live points and the free slots (fresh + stack), printed
    and kept. Reading them waits for the card once a segment."""

    def __init__(self, every: int = 100):
        self.every = every
        self.rows = []
        self._last = None

    def __call__(self, frames: int, pipe) -> None:
        import torch
        if self._last is None:          # segments start after one chunk
            self._last = (frames, time.perf_counter())
            return
        if frames // self.every == self._last[0] // self.every:
            return
        pipe.finish()
        now = time.perf_counter()
        m = pipe.state.map
        live = int(m.pts_valid.sum())
        fresh = m.capacity_pts - int(m.num_pts)
        stack = int(m.free_count)
        f0, t0 = self._last
        row = dict(frames=frames, fps=(frames - f0) / max(now - t0, 1e-9),
                   live_points=live, free_slots=fresh + stack,
                   free_fresh=fresh, free_stack=stack,
                   keyframes=int(m.num_kf))
        if torch.cuda.is_available() and m.pts_valid.is_cuda:
            row["allocated_gb"] = torch.cuda.memory_allocated() / 1e9
        self.rows.append(row)
        self._last = (frames, now)
        print(f"frames {frames}: {row['fps']:.2f} fps over frames "
              f"{f0}-{frames}, live points {live}, free slots "
              f"{fresh + stack} (fresh {fresh} + stack {stack}), keyframes "
              f"{row['keyframes']}", flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from gl_slam_tpu_torch.device import resolve_device
    from gl_slam_tpu_torch.train import e2e, evals

    t_start = time.perf_counter()
    dev = resolve_device(args.device)
    args.device = dev
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sp, lg, subpix, scene, cfg, run = setup(args)
    n = args.frames
    segments = Segments()
    diag = {}
    res = e2e.run_learned_e2e(sp, lg, scene, cfg, n_frames=n, device=dev,
                              subpix=subpix, diag_out=diag,
                              on_chunk=segments, **run)
    report = {}
    if args.preset == "flagship":
        report["preset"] = "flagship"
    report.update({
        "frames": res.num_frames,
        "keyframes": res.num_keyframes,
        "ate_rmse_m": round(res.ate_m, 4),
        "trajectory_len_m": float(res.num_frames),  # 1 m/frame scene speed
        "drift_pct": round(100.0 * res.ate_m / max(res.num_frames, 1), 3),
        "fps_steady": round(res.fps, 2),
        "ba_runs": res.num_ba_runs,
        "mean_matches": round(res.mean_matches, 1),
        "max_points_capacity": cfg.map.max_points,
        "total_new_points": res.total_new_points,
        "loop_closures": res.loop_closures,
        "reobs": "lightglue" if args.preset == "flagship" else args.reobs,
        "card": evals.device_line(dev),
        "wall_s": round(time.perf_counter() - t_start, 1),
        "peak_allocated_gb": round(torch.cuda.max_memory_allocated(dev)
                                   / 1e9, 2) if dev.type == "cuda" else None,
        "loop_detections": len(diag["loop_checks"]),
        "num_rejected": res.num_rejected,
        "num_recoveries": diag["num_recoveries"],
        "segments": segments.rows,
    })
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
