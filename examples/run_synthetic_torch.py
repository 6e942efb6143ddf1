"""Demo: the port's SLAM pipeline on a synthetic KITTI-like sequence.

Usage:  python examples/run_synthetic_torch.py [--frames N] [--noise PX]
            [--no-ba] [--device cpu]

Counterpart of examples/run_synthetic.py on the PyTorch/CUDA port:
bootstrap + per-frame tracking + sliding-window BA with the oracle front
end (projected landmarks with descriptor identities), then per-frame
ground-truth errors, ATE-RMSE and map statistics. Runs on the CUDA card by
default (and raises without one); `--device cpu` runs on the CPU.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gl_slam_tpu_torch import metrics  # noqa: E402
from gl_slam_tpu_torch.config import (BAConfig, FrontendConfig,  # noqa: E402
                                      GeometryConfig, MapConfig, SLAMConfig)
from gl_slam_tpu_torch.io import synthetic  # noqa: E402
from gl_slam_tpu_torch.slam.pipeline import TrackingPipeline  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--noise", type=float, default=0.2)
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--kpts", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    H, W, D = 240, 320, 64
    # The geometric gates scale with the injected detection noise: the
    # default thresholds (0.5 / 0.1 px) assume a sub-pixel-refined front
    # end, and noisier detections through them starve triangulation.
    nz = max(args.noise, 0.25)
    cfg = SLAMConfig(
        frontend=FrontendConfig(image_height=H, image_width=W,
                                max_keypoints=args.kpts, descriptor_dim=D),
        geometry=GeometryConfig(essential_hypotheses=128,
                                essential_threshold_px=max(0.5, nz),
                                triangulation_reproj_px=2.0 * nz,
                                triangulation_reproj_bootstrap_px=2.0 * nz,
                                min_parallax_deg=0.5),
        ba=BAConfig(max_window_cameras=12, max_window_points=2048,
                    full_ba_iters=15, pose_only_iters=15),
        map=MapConfig(max_keyframes=max(64, args.frames + 2),
                      max_points=16384, covis_max_points=256,
                      covis_edge_threshold=10),
    )
    scene = synthetic.make_scene(num_landmarks=3000, num_frames=args.frames,
                                 height=H, width=W, desc_dim=D, seed=7)
    obs = [synthetic.observe_frame(scene, i, max_keypoints=args.kpts,
                                   noise_px=args.noise, seed=11)
           for i in range(args.frames)]

    pipe = TrackingPipeline(cfg, scene.K, enable_ba=not args.no_ba,
                            device=args.device)
    c0 = -scene.poses_R[0].T @ scene.poses_t[0]
    c1 = -scene.poses_R[1].T @ scene.poses_t[1]
    t_start = time.time()
    pipe.bootstrap((obs[0].keypoints, obs[0].descriptors, obs[0].valid, 0),
                   (obs[1].keypoints, obs[1].descriptors, obs[1].valid, 1),
                   gt_scale=float(np.linalg.norm(c1 - c0)))
    outs = [pipe.step(obs[i].keypoints, obs[i].descriptors, obs[i].valid, i)
            for i in range(2, args.frames)]
    pipe.finish()
    elapsed = time.time() - t_start

    R, t, fidx = pipe.trajectory()
    errs = metrics.per_frame_pose_errors(R, t, scene.poses_R[fidx],
                                         scene.poses_t[fidx])
    by_frame = {i: o for i, o in zip(range(2, args.frames), outs)}
    print(f"{'frame':>5} {'rot(deg)':>9} {'t-dir(deg)':>10} {'t-mag(m)':>9}"
          f" {'matches':>8} {'map':>6} {'new':>5}")
    for k in range(len(R)):
        o = by_frame.get(int(fidx[k]))
        cols = (f"{int(o.num_matches):>8} {int(o.num_map_matches):>6} "
                f"{int(o.num_new_points):>5}") if o is not None \
            else f"{'-':>8} {'-':>6} {'-':>5}"
        print(f"{int(fidx[k]):>5} {errs.rot_deg[k]:>9.4f} "
              f"{errs.t_dir_deg[k]:>10.4f} {errs.t_mag[k]:>9.4f} " + cols)

    c_est = metrics.camera_centers(R, t)
    c_gt = metrics.camera_centers(scene.poses_R[fidx], scene.poses_t[fidx])
    ate = metrics.ate_rmse(c_est, c_gt, align=False)
    print(f"\nATE-RMSE (no alignment): {ate:.4f} m over {len(R)} frames")
    print(f"map: {pipe.map_stats()}")
    print(f"wall: {elapsed:.1f}s ({len(R) / elapsed:.1f} fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
