"""Loop-closure A/B on the PyTorch/CUDA port.

Tracks a closed-circle revisit (synthetic motion="loop": one lap per
`--period` frames, the tail re-traversing the first lap) with the flagship
front end and pair sub-pixel head through the chunked driver, twice: loop
closing off, then on. A closure must fire on the revisit and lower the
final ATE. Writes one JSON report; tests/test_torch_eval_reports.py holds
it to the bounds of tests/test_loopclose.py.

    python scripts/eval_loopclose_torch.py           # on the card, 2 x 420
    python scripts/eval_loopclose_torch.py --device cpu --frames 40 \\
        --period 32
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--period", type=int, default=360,
                    help="circle period < frames gives a re-traversal tail")
    ap.add_argument("--seed", type=int, default=31)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--ba-every", type=int, default=8)
    ap.add_argument("--domain", default="clean", choices=["clean", "hard"])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "checkpoints"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "LOOPCLOSE_EVAL_TORCH.json"))
    args = ap.parse_args()

    from gl_slam_tpu_torch.train import evals

    report = evals.loopclose_ab(
        args.ckpt, frames=args.frames, period=args.period, seed=args.seed,
        chunk=args.chunk, ba_every=args.ba_every, domain=args.domain,
        device=args.device)
    print(json.dumps(report))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
