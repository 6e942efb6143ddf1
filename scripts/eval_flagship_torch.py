"""The flagship scenario on the PyTorch/CUDA port: quality and speed from
one run.

Tracks the 120-frame held-out flagship sequence (376x1241, N=2048, D=256,
the 9-layer matcher on all three passes per frame (two with --reobs-mode
merged or batched), the committed flagship
weights and sub-pixel head (pair by default; --subpix single or
centroid), window BA every 8 frames, loop closing on, in the clean or the
hard photometric domain) through
`gl_slam_tpu_torch.train.e2e.run_learned_e2e` and writes one JSON report:
ATE (m and % of the ~1 m-per-frame trajectory), keyframes, BA runs,
matches, rejected frames, tracked fps, loop closures, the card's name and
power limit. tests/test_torch_eval_reports.py holds the report to
the bounds of tests/test_flagship_e2e.py.

    python scripts/eval_flagship_torch.py            # on the card
    python scripts/eval_flagship_torch.py --domain hard
    python scripts/eval_flagship_torch.py --reobs-mode batched \
        --out FLAGSHIP_EVAL_BATCHED_TORCH.json
    python scripts/eval_flagship_torch.py --device cpu --frames 26
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seed", type=int, default=101,
                    help="held-out scene seed (training used 7, 17, 27)")
    ap.add_argument("--landmarks", type=int, default=20000)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--motion", default="forward_turn")
    ap.add_argument("--subpix", default="pair",
                    choices=["pair", "single", "centroid"])
    ap.add_argument("--reobs-mode", default="separate",
                    choices=["separate", "merged", "batched"],
                    help="the re-observation passes: separate (LightGlue "
                         "x3 a frame, as the reference), merged (one pass "
                         "over the union of both candidate pools) or "
                         "batched (both pools in one batch-2 call)")
    ap.add_argument("--domain", default="clean", choices=["clean", "hard"])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "checkpoints"))
    ap.add_argument("--out", default=None,
                    help="default: FLAGSHIP_EVAL_TORCH.json at the repo "
                         "root (FLAGSHIP_EVAL_HARD_TORCH.json for --domain "
                         "hard)")
    args = ap.parse_args()
    if args.out is None:
        name = "FLAGSHIP_EVAL_TORCH.json" if args.domain == "clean" \
            else "FLAGSHIP_EVAL_HARD_TORCH.json"
        args.out = os.path.join(ROOT, name)

    from gl_slam_tpu_torch.train import evals

    report = evals.flagship_eval(
        args.ckpt, frames=args.frames, seed=args.seed,
        landmarks=args.landmarks, chunk=args.chunk, motion=args.motion,
        subpix=args.subpix, domain=args.domain, reobs_mode=args.reobs_mode,
        device=args.device)
    print(json.dumps(report))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
