"""The port's command line fed through the native PNG prefetch loader.

Counterpart of scripts/eval_native_loader.py on the PyTorch/CUDA port:

  1. renders the held-out hard-domain flagship sequence (seed 101,
     forward_turn: repetitive structure, illumination drift, occluders,
     sensor noise) and writes its first --frames frames as a KITTI-layout
     tree (sequences/00/image_0/%06d.png 8-bit grayscale, calib.txt with a
     P0 row, poses/00.txt ground truth);
  2. runs the port's command line over the tree (`gl-slam-tpu-torch run
     --frontend superpoint --preset flagship`, the pair head), whose KITTI
     route decodes every frame through runtime/native_lib.NativeLoader;
  3. writes the command line's report with `native_loader`, `domain`,
     `png_tree_frames`, `seed`, the frames the loader delivered, and the
     card's name and power limit (NATIVE_LOADER_EVAL_TORCH.json at the
     repo root by default). tests/test_torch_eval_reports.py holds it to
     the bounds of tests/test_runtime.py's native-loader eval.

It refuses to run where the native loader does not build (no g++): the
report is evidence for that loader.

    python scripts/eval_native_loader_torch.py           # on the card
    python scripts/eval_native_loader_torch.py --device cpu --frames 12
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def write_kitti_tree(root: str, scene, frames: np.ndarray) -> None:
    """The KITTI odometry layout of the JAX eval's writer: 8-bit frames,
    a P0 row, camera-to-world 3x4 ground-truth rows."""
    from PIL import Image

    seq = os.path.join(root, "sequences", "00")
    img_dir = os.path.join(seq, "image_0")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    for i, f in enumerate(frames):
        a = np.clip(f * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(a, mode="L").save(
            os.path.join(img_dir, f"{i:06d}.png"))
    K = np.asarray(scene.K, np.float64)
    P0 = np.hstack([K, np.zeros((3, 1))]).reshape(-1)
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write("P0: " + " ".join(f"{v:.12e}" for v in P0) + "\n")
    rows = []
    for i in range(len(frames)):
        R = np.asarray(scene.poses_R[i], np.float64)   # world -> camera
        t = np.asarray(scene.poses_t[i], np.float64)
        rows.append(np.hstack([R.T, (-R.T @ t)[:, None]]).reshape(-1))
    np.savetxt(os.path.join(root, "poses", "00.txt"), np.array(rows))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=66)
    ap.add_argument("--seed", type=int, default=101)
    ap.add_argument("--domain", default="hard", choices=["clean", "hard"])
    ap.add_argument("--tree", default=os.path.join(
        ROOT, "chiprun_out", "kitti_native_eval"))
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "NATIVE_LOADER_EVAL_TORCH.json"))
    args = ap.parse_args(argv)

    from gl_slam_tpu_torch.runtime import native_lib
    if not native_lib.available():
        raise SystemExit("the native PNG loader does not build here ("
                         f"{native_lib.build_error()}); this eval is "
                         "evidence for that loader")

    from gl_slam_tpu_torch import cli
    from gl_slam_tpu_torch.config import flagship_config
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.train.evals import device_line

    cfg = flagship_config()
    H, W = cfg.frontend.image_height, cfg.frontend.image_width
    n = args.frames
    scene = synthetic.make_scene(
        num_landmarks=20000, num_frames=max(n, 120), height=H, width=W,
        desc_dim=cfg.frontend.descriptor_dim, seed=args.seed,
        motion="forward_turn")
    stack = np.stack([synthetic.render_frame(scene, i, max_keypoints=2048,
                                             domain=args.domain)
                      for i in range(n)]).astype(np.float32)
    shutil.rmtree(args.tree, ignore_errors=True)
    write_kitti_tree(args.tree, scene, stack)

    argv_cli = ["run", "--dataset", args.tree, "--sequence", "00",
                "--frontend", "superpoint", "--preset", "flagship",
                "--weights", os.path.join(ROOT, "checkpoints"),
                "--first-frame", "0", "--last-frame", str(n - 1),
                "--out", os.path.join(args.tree, "out")]
    if args.device is not None:
        argv_cli += ["--device", args.device]
    native_lib.reset_frame_count()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv_cli)
    text = buf.getvalue()
    print(text)
    if rc not in (0, None):
        raise SystemExit(f"command line failed, rc={rc}")
    rep = json.loads(text[text.index("{"):])
    delivered = native_lib.DELIVERED["frames"]
    if delivered != n:
        raise SystemExit(f"the native loader delivered {delivered} frames, "
                         f"{n} were fed")
    rep.update(native_loader=True, domain=args.domain, png_tree_frames=n,
               seed=args.seed, loader_frames_delivered=delivered,
               card=device_line(args.device))
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
