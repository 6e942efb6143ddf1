#!/usr/bin/env python3
"""Time the port's NMS kernel at the tracker's two path shapes.

    python3 scripts/bench_nms_torch.py [--root DIR] [--reps N] [--sweep-segs]

Imports gl_slam_tpu_torch from DIR (default: this checkout), builds its
kernels, and at each path shape (a chunk's 8 detector maps and the
bootstrap's 2, 376 x 1248 after padding to multiples of 8, radius 4; a
quantised random map with exact zeros and plateaus, as chip_smoke.py makes
it) holds `nms_cuda` against `nms_plain` bit for bit. It prints one JSON
line: the card, and per shape
  - `ms`: the kernel's device time per call, by CUDA events around `reps`
    back-to-back calls that a spin kernel holds until all are issued;
  - `max_pool2d_ms`: one `F.max_pool2d` of the same window (the window max
    alone, no tie-break), timed the same way;
  - `bound_ms`: the map read once and the output written once at the
    memory rate;
  - `equal` (to the plain version) and `host_us_per_call` (median of 5
    rounds of `--host-calls` calls);
  - the plan (strips, rows per segment, segments, CTAs) where the checkout
    has `nms_plan`, and with --sweep-segs the time at each segment length
    in SEG_SWEEP.
Two checkouts are compared by running this on each in turn on one card:
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((8, 376, 1248), (2, 376, 1248))
RADIUS = 4
SEG_SWEEP = (8, 12, 16, 20, 24, 28, 32, 35, 40, 47, 63, 94, 188, 376)
SPIN_CYCLES = 50_000_000    # spin kernel ahead of a timed run, ~25 ms
PEAK_BYTES = 3.35e12        # H100 SXM data sheet


def time_ms(torch, fn, reps, warmup=3):
    """Device time per call: CUDA events around `reps` back-to-back calls,
    behind a spin kernel that holds the stream while the host issues
    them."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_map(torch, gen, dev, B, H, W):
    heat = torch.rand(B, H, W, generator=gen, device=dev)
    heat = torch.round(heat * 64) / 64
    heat[torch.rand(B, H, W, generator=gen, device=dev) < 0.3] = 0.0
    heat[0, 28:37, 50:80] = 1.97
    heat[0, 120:136, 600:700] = 1.98
    heat[-1, H // 2, :] = 1.96
    return heat.contiguous()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--host-calls", type=int, default=200)
    ap.add_argument("--sweep-segs", action="store_true",
                    help="also time each shape at every segment length in "
                         "SEG_SWEEP (checkouts whose kernel takes one)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_nms_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.ops import nms as NM
    F = torch.nn.functional
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    reports = _build.build_all()
    ptxas = [ln.strip() for ln in reports.get("nms", "").splitlines()
             if "registers" in ln or "spill" in ln]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    r, k = RADIUS, 2 * RADIUS + 1
    has_plan = hasattr(NM, "nms_plan")
    rows = []
    for B, H, W in SHAPES:
        heat = random_map(torch, gen, dev, B, H, W)
        before = _build.LAUNCHES["nms"]
        out = NM.nms_cuda(heat, r)
        launches = _build.LAUNCHES["nms"] - before
        equal = bool(torch.equal(out, NM.nms_plain(heat, r)))
        row = dict(shape=f"{B}x{H}x{W}", radius=r, equal=equal,
                   launches_per_call=launches,
                   ms=time_ms(torch, lambda: NM.nms_cuda(heat, r), args.reps),
                   max_pool2d_ms=time_ms(torch, lambda: F.max_pool2d(
                       heat[:, None], k, stride=1, padding=r), args.reps),
                   bound_ms=2 * 4 * heat.numel() / PEAK_BYTES * 1e3)
        if has_plan:
            row["plan"] = NM.nms_plan(B, H, W, r)
            if args.sweep_segs:
                row["sweep_ms"] = {}
                for seg in SEG_SWEEP:
                    got = NM.nms_cuda(heat, r, seg_rows=seg)
                    if not torch.equal(got, out):
                        print(f"bench_nms_torch: seg_rows={seg} differs",
                              file=sys.stderr)
                        return 1
                    row["sweep_ms"][seg] = time_ms(
                        torch, lambda s=seg: NM.nms_cuda(heat, r, seg_rows=s),
                        args.reps)
        rounds = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.host_calls):
                NM.nms_cuda(heat, r)
            rounds.append((time.perf_counter() - t0) / args.host_calls * 1e6)
            torch.cuda.synchronize()
        row["host_us_per_call"] = sorted(rounds)[2]
        rows.append(row)
        print(f"  {row['shape']}: {row}", file=sys.stderr, flush=True)
        if not equal:
            print("bench_nms_torch: kernel differs from the plain version",
                  file=sys.stderr)
            return 1
    print(json.dumps(dict(root=os.path.abspath(args.root), card=card,
                          ptxas=ptxas, shapes=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
