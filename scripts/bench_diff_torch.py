"""Perf-regression guard of the port: diff a fresh stage profile against
the committed baseline (the counterpart of scripts/bench_diff.py).

Usage (on the card; the baseline is PERF_BASELINE_TORCH.json):
  python3 scripts/profile_stages_torch.py --json /tmp/stages.json
  python3 scripts/bench_diff_torch.py /tmp/stages.json
  python3 scripts/bench_diff_torch.py /tmp/stages.json --update   # accept it

Exit code 1 if any stage's host ms a call (`stages_ms`) rose by more than
--tol (default 15 %) over the baseline's. The baseline file is a run of
scripts/profile_stages_torch.py on an H100 with the card's name and power
limit in it: compare runs on the same kind of card, and update it whenever
a deliberate change to a stage lands."""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "PERF_BASELINE_TORCH.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("current",
                    help="stage JSON from profile_stages_torch --json")
    ap.add_argument("--baseline", default=BASELINE)
    ap.add_argument("--tol", type=float, default=0.15,
                    help="fractional slowdown that counts as a regression")
    ap.add_argument("--update", action="store_true",
                    help="overwrite the baseline with the current profile")
    args = ap.parse_args(argv)

    with open(args.current) as f:
        cur = json.load(f)
    if args.update or not os.path.exists(args.baseline):
        with open(args.baseline, "w") as f:
            json.dump(cur, f, indent=1)
        print(f"baseline {'updated' if args.update else 'created'}: "
              f"{args.baseline}")
        return 0

    with open(args.baseline) as f:
        base = json.load(f)
    for key in ("backend", "card"):
        if cur.get(key) != base.get(key):
            print(f"WARNING: {key} differs (baseline {base.get(key)}, "
                  f"current {cur.get(key)}): deltas not comparable")

    regressions = []
    print(f"{'stage':>28} {'base ms':>9} {'cur ms':>9} {'delta':>8}")
    for name, b in base["stages_ms"].items():
        c = cur["stages_ms"].get(name)
        if c is None:
            print(f"{name:>28} {b:9.3f} {'-':>9} {'GONE':>8}")
            continue
        d = (c - b) / b
        flag = " <-- REGRESSED" if d > args.tol else ""
        print(f"{name:>28} {b:9.3f} {c:9.3f} {d:+7.1%}{flag}")
        if d > args.tol:
            regressions.append((name, b, c))
    for name in sorted(set(cur["stages_ms"]) - set(base["stages_ms"])):
        print(f"{name:>28} {'-':>9} {cur['stages_ms'][name]:9.3f} "
              f"{'NEW':>8}")

    if regressions:
        print(f"\n{len(regressions)} stage(s) regressed beyond "
              f"{args.tol:.0%}")
        return 1
    print("\nno regressions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
