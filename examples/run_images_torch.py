"""Demo: the port's SLAM from raw images with the classical (Harris) front
end.

Usage:  python examples/run_images_torch.py [--frames N] [--device cpu]

Counterpart of examples/run_images.py on the PyTorch/CUDA port: render
synthetic frames, extract keypoints and patch descriptors with the
training-free Harris front end (NMS through the hand-written kernel on
the card) and track them through the per-frame pipeline. Runs on the CUDA
card by default (and raises without one); `--device cpu` runs on the CPU.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gl_slam_tpu_torch import metrics  # noqa: E402
from gl_slam_tpu_torch.config import (BAConfig, FrontendConfig,  # noqa: E402
                                      GeometryConfig, MapConfig, SLAMConfig)
from gl_slam_tpu_torch.device import resolve_device, upload  # noqa: E402
from gl_slam_tpu_torch.io import synthetic  # noqa: E402
from gl_slam_tpu_torch.models.classical import HarrisExtractor  # noqa: E402
from gl_slam_tpu_torch.slam.pipeline import TrackingPipeline  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--kpts", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    H, W = 240, 320
    PATCH = 8
    cfg = SLAMConfig(
        frontend=FrontendConfig(image_height=H, image_width=W,
                                max_keypoints=args.kpts,
                                descriptor_dim=PATCH * PATCH,
                                match_threshold=0.5, map_match_threshold=0.5),
        geometry=GeometryConfig(essential_hypotheses=256,
                                essential_threshold_px=2.0,
                                triangulation_reproj_px=2.0),
        ba=BAConfig(max_window_cameras=12, max_window_points=4096,
                    full_ba_iters=15, pose_only_iters=15),
        map=MapConfig(max_keyframes=64, max_points=16384,
                      covis_max_points=512, covis_edge_threshold=10),
    )
    scene = synthetic.make_scene(num_landmarks=1500, num_frames=args.frames,
                                 height=H, width=W, seed=21)
    print("rendering frames...")
    imgs = np.stack([synthetic.render_frame(scene, i, max_keypoints=700)
                     for i in range(args.frames)]).astype(np.float32)

    ex = HarrisExtractor(H, W, max_keypoints=args.kpts, patch=PATCH)
    t0 = time.time()
    kpts, _, desc, valid = ex(upload(imgs, torch.float32, dev))
    kpts, desc, valid = (x.cpu().numpy() for x in (kpts, desc, valid))
    print(f"extracted {valid.sum(1).tolist()} kpts/frame "
          f"in {time.time() - t0:.1f}s")

    pipe = TrackingPipeline(cfg, scene.K, device=dev)
    c0 = -scene.poses_R[0].T @ scene.poses_t[0]
    c1 = -scene.poses_R[1].T @ scene.poses_t[1]
    pipe.bootstrap((kpts[0], desc[0], valid[0], 0),
                   (kpts[1], desc[1], valid[1], 1),
                   gt_scale=float(np.linalg.norm(c1 - c0)))
    for i in range(2, args.frames):
        pipe.step(kpts[i], desc[i], valid[i], i)
    pipe.finish()

    R, t, fidx = pipe.trajectory()
    errs = metrics.per_frame_pose_errors(R, t, scene.poses_R[fidx],
                                         scene.poses_t[fidx])
    c_est = metrics.camera_centers(R, t)
    c_gt = metrics.camera_centers(scene.poses_R[fidx], scene.poses_t[fidx])
    ate = metrics.ate_rmse(c_est, c_gt, align=False)
    print(f"tracked {len(R)}/{args.frames} frames from raw images")
    print(f"rot err max {errs.rot_deg.max():.3f} deg, "
          f"t-mag err max {errs.t_mag.max():.3f} m")
    print(f"ATE-RMSE (no alignment): {ate:.4f} m")
    print(f"map: {pipe.map_stats()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
