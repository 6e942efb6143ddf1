#!/usr/bin/env python3
"""Time the port's assignment kernel at the tracker's three path shapes.

    python3 scripts/bench_assignment_torch.py [--root DIR] [--reps N]
        [--sweep-splits]

Imports gl_slam_tpu_torch from DIR (default: this checkout), builds its
kernels, and at each path shape (the chunk prologue's 8 pairs at 2048 x
2048, the bootstrap's 1 pair at 2048 x 2048 and a re-observation call's
1024 candidates x 2048 keypoints; 256-d bf16 features, inputs as
chip_smoke.py makes them) holds `fused_reductions_cuda` against
`fused_reductions_plain`. It prints one JSON line: the card, and per shape
  - `ms`: the kernel's device time per call, by CUDA events around `reps`
    back-to-back calls that a spin kernel holds until all are issued;
  - `bmm_ms` and `two_bmm_ms`: one and two bf16 `torch.matmul(f0, f1^T)`
    calls on the same inputs, timed the same way (the kernel computes that
    product twice, once per pass);
  - `bound_ms`: two passes of f0 f1^T at the bf16 tensor-core peak, or the
    inputs read once and the outputs written once at the memory rate,
    whichever is larger;
  - `max_abs_err` against the plain version (values), `bit_equal` (two
    calls give the same bits), and `host_us_per_call`;
  - the plan (row tile, column tile, column splits, CTAs) where the
    checkout has `assign_plan`, and with --sweep-splits the time at every
    split in 1, 2, 4, 8, 16, 32 that the shape allows;
  - `kernel_ms`: device time per launch of each kernel the call launches,
    by name, from torch.profiler over `reps` calls.
Two checkouts are compared by running this on each in turn on one card:
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK, N_KPTS, M_REOBS, FEAT_DIM = 8, 2048, 1024, 256
SPIN_CYCLES = 50_000_000    # spin kernel ahead of a timed run, ~25 ms
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12   # H100 SXM data sheet


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


def kernel_ms(torch, fn, reps):
    """{kernel name: device ms per launch} over `reps` calls of fn."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0][:60]
            t, n = out.get(name, (0.0, 0))
            out[name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    return {k: t / n for k, (t, n) in out.items()}


def path_cases(torch, gen, dev):
    """(name, f0, f1, c0, c1, m0, m1): 90 % of rows and columns valid, a
    fully masked row and column, and in the prologue a pair whose columns
    are all masked but one."""
    F = torch.nn.functional
    cases = []
    for name, B, N, M in (
            (f"prologue {CHUNK}x{N_KPTS}x{N_KPTS}", CHUNK, N_KPTS, N_KPTS),
            (f"bootstrap 1x{N_KPTS}x{N_KPTS}", 1, N_KPTS, N_KPTS),
            (f"reobs 1x{M_REOBS}x{N_KPTS}", 1, M_REOBS, N_KPTS)):
        f0 = (torch.randn(B, N, FEAT_DIM, generator=gen, device=dev) / 4).to(
            torch.bfloat16)
        f1 = (torch.randn(B, M, FEAT_DIM, generator=gen, device=dev) / 4).to(
            torch.bfloat16)
        c0 = F.logsigmoid(torch.randn(B, N, generator=gen, device=dev))
        c1 = F.logsigmoid(torch.randn(B, M, generator=gen, device=dev))
        m0 = torch.rand(B, N, generator=gen, device=dev) < 0.9
        m1 = torch.rand(B, M, generator=gen, device=dev) < 0.9
        m0[0, 3] = False
        m1[0, 7] = False
        if B > 1:
            m1[-1, :] = False
            m1[-1, 9] = True
        cases.append((name, f0, f1, c0, c1, m0, m1))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--host-calls", type=int, default=100)
    ap.add_argument("--sweep-splits", action="store_true",
                    help="also time each shape at every column split the "
                         "checkout's assign_plan allows")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_assignment_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.ops import assignment as AS
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    reports = _build.build_all()
    ptxas = [ln.strip() for ln in reports.get("assignment", "").splitlines()
             if "registers" in ln or "spill" in ln]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = 1.0 / math.sqrt(FEAT_DIM)
    rows = []
    for name, f0, f1, c0, c1, m0, m1 in path_cases(torch, gen, dev):
        args_ = (f0, f1, c0, c1, m0, m1, scale)
        out = AS.fused_reductions_cuda(*args_)
        again = AS.fused_reductions_cuda(*args_)
        ref = AS.fused_reductions_plain(*args_)
        torch.cuda.synchronize()
        err = max(float((a - r).abs().max()) for a, r in
                  zip(out, ref) if a.dtype == torch.float32)
        bit_equal = all(torch.equal(a, b) for a, b in zip(out, again))
        del ref
        B, N, Df = f0.shape
        M = f1.shape[1]
        f1t = f1.transpose(1, 2)

        def kernel():
            AS.fused_reductions_cuda(*args_)

        def bmm():
            torch.matmul(f0, f1t)

        def two_bmm():
            torch.matmul(f0, f1t)
            torch.matmul(f0, f1t)

        flops = 2 * 2.0 * B * N * M * Df
        nbytes = 2 * (f0.numel() + f1.numel()) + 5 * (B * N + B * M) \
            + 12 * (B * N + B * M)
        row = dict(shape=name, max_abs_err=err, bit_equal=bit_equal,
                   ms=time_ms(torch, kernel, args.reps),
                   bmm_ms=time_ms(torch, bmm, args.reps),
                   two_bmm_ms=time_ms(torch, two_bmm, args.reps),
                   bound_ms=max(flops / PEAK_BF16_FLOPS,
                                nbytes / PEAK_BYTES) * 1e3)
        if hasattr(AS, "assign_plan"):
            row_tile, col_tile, splits = AS.assign_plan(B, N, M)
            row.update(row_tile=row_tile, col_tile=col_tile, splits=splits,
                       ctas=-(-N // row_tile) * B * splits)
            if args.sweep_splits:
                plan, row["sweep_ms"] = AS.assign_plan, {}
                tiles = -(-M // col_tile)
                for S in (1, 2, 4, 8, 16, 32):
                    if S > tiles:
                        break
                    AS.assign_plan = lambda *_, S=S: (row_tile, col_tile, S)
                    row["sweep_ms"][S] = time_ms(torch, kernel, args.reps)
                AS.assign_plan = plan
        row["kernel_ms"] = kernel_ms(torch, kernel, args.reps)
        rounds = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.host_calls):
                kernel()
            rounds.append((time.perf_counter() - t0) / args.host_calls * 1e6)
            torch.cuda.synchronize()
        row["host_us_per_call"] = sorted(rounds)[2]
        rows.append(row)
        print(f"  {name}: {row}", file=sys.stderr, flush=True)
    print(json.dumps(dict(root=os.path.abspath(args.root), card=card,
                          ptxas=ptxas, launches=_build.LAUNCHES["assignment"],
                          shapes=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
