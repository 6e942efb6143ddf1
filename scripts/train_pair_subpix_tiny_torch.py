"""Train ONLY the pair-conditioned sub-pixel head at the tiny preset on the
PyTorch/CUDA port, against the frozen committed sp_tiny.npz (the
counterpart of scripts/train_pair_subpix_tiny.py). Writes
<out>/kspair_tiny.npz (default trained_torch/, git-ignored; never the
repository's checkpoints/) and prints the held-out comparison of the
centroid, the committed single-view head and the new pair head.

    python scripts/train_pair_subpix_tiny_torch.py            # on the card
    python scripts/train_pair_subpix_tiny_torch.py --device cpu --steps 20
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from train_frontend_torch import (DEFAULT_OUT, PAIR_STEPS,  # noqa: E402
                                  checked_out_dir, evaluate)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=PAIR_STEPS)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    out = checked_out_dir(args.out)

    from gl_slam_tpu_torch import checkpoint as ckpt
    from gl_slam_tpu_torch.config import TINY_DESC_DIM
    from gl_slam_tpu_torch.device import resolve_device
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.models.subpix import PairSubpixHead
    from gl_slam_tpu_torch.train import e2e
    from gl_slam_tpu_torch.train import frontend_train as ft

    dev = resolve_device(args.device)
    # the scene recipe of scripts/train_frontend_torch.py --preset tiny
    H, W, N, D = 160, 240, 96, TINY_DESC_DIM
    scenes = [synthetic.make_scene(num_landmarks=700, num_frames=36,
                                   height=H, width=W, desc_dim=D,
                                   seed=7 + 10 * s) for s in range(6)]
    committed = os.path.join(ROOT, "checkpoints")
    sp, _ = e2e.load_tiny_frontend(committed, device=dev)
    head = PairSubpixHead(D, patch=7, offset_range=1.5)
    ft.train_pair_subpix(head, sp, scenes, 20, N, steps=args.steps,
                         log_every=100, device=dev)
    os.makedirs(out, exist_ok=True)
    path = ckpt.params_path(out, "kspair_tiny")
    ckpt.save_params(path, head)
    print(f"saved {path}")
    ks = e2e.load_tiny_subpix(committed, device=dev)
    evaluate(sp, ks, head.eval(), H, W, N, D, 700, dev)


if __name__ == "__main__":
    main()
