#!/usr/bin/env python3
"""Time the port's attention kernel at the tracker's five path shapes.

    python3 scripts/bench_attention_torch.py [--root DIR] [--reps N]
        [--sweep-splits]

Imports gl_slam_tpu_torch from DIR (default: this checkout), builds its
kernels, and at each path shape (the prologue's 8 pairs x 2 sets x 2 heads
at 2048 x 2048, and the re-observation calls' 2 heads at (Nq, Nk) in
{1024, 2048}^2, dh 128, inputs as chip_smoke.py makes them) holds the
kernel against `attention_plain` within `attention_tolerance`. It prints
one JSON line: the card, and per shape
  - `ms`: the kernel's device time per launch, by CUDA events around
    `reps` back-to-back launches that a spin kernel holds until all are
    issued; `events_ms` the same without the spin kernel (which the host
    bounds where a launch takes longer to issue than to run);
  - `sdpa_ms` and `sdpa_events_ms` for one F.scaled_dot_product_attention
    call on the same inputs;
  - the key tile, split and CTA count where the checkout has `split_plan`,
    and with --sweep-splits the time at every split S in {1, 2, 4, 8} of
    each split shape;
  - the error over its bound, and `host_us_per_call`, the host time per
    `attention_cuda` call (host clock over back-to-back calls, no
    synchronisation inside).
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
CHUNK, HEADS, HEAD_DIM, N_KPTS, M_REOBS = 8, 2, 128, 2048, 1024
SPIN_CYCLES = 50_000_000    # spin kernel ahead of a timed run, ~25 ms


def time_ms(torch, fn, reps, warmup=3, spin=0):
    """Per call, by CUDA events around `reps` back-to-back calls; with
    `spin` cycles of a spin kernel ahead of the first event, which hold the
    stream while the host issues the calls, the device's time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if spin:
        torch.cuda._sleep(spin)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def path_cases(torch, gen, dev):
    """(name, q, k, v, mask): each query is 0.75 x one key, 80 % of keys
    valid (ragged counts and one fully masked set in the prologue)."""
    def needle(lead, nq, nk):
        k, v = (torch.randn(*lead, HEADS, nk, HEAD_DIM, generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        j = (torch.arange(nq, device=dev) * 997) % nk
        return (0.75 * k.float()[..., j, :]).to(torch.bfloat16), k, v

    q, k, v = needle((CHUNK, 2), N_KPTS, N_KPTS)
    counts = torch.randint(N_KPTS // 2, N_KPTS + 1, (CHUNK, 2), generator=gen,
                           device=dev)
    mask = torch.arange(N_KPTS, device=dev) < counts[..., None]
    mask[0, 1] = False
    cases = [(f"prologue {CHUNK}x2x{HEADS}x{N_KPTS}x{N_KPTS}", q, k, v, mask)]
    for nq, nk in ((M_REOBS, M_REOBS), (N_KPTS, N_KPTS), (M_REOBS, N_KPTS),
                   (N_KPTS, M_REOBS)):
        q, k, v = needle((), nq, nk)
        mask = torch.rand(nk, generator=gen, device=dev) < 0.8
        cases.append((f"reobs {HEADS}x{nq}x{nk}", q, k, v, mask))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--host-calls", type=int, default=100)
    ap.add_argument("--sweep-splits", action="store_true",
                    help="also time each re-observation shape at every key "
                         "split S in 1, 2, 4, 8 (the checkout's split tile)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_attention_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.ops import attention as A
    F = torch.nn.functional
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    reports = _build.build_all()
    ptxas = [ln.strip() for ln in reports.get("attention", "").splitlines()
             if "registers" in ln or "spill" in ln]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, q, k, v, mask in path_cases(torch, gen, dev):
        scale = 1.0 / math.sqrt(q.shape[-1])
        out = A.attention_cuda(q, k, v, mask, scale)
        ref = A.attention_plain(q, k, v, mask, scale)
        tol = A.attention_tolerance(q, k, v, mask, scale)
        over = float(((out - ref).abs() / tol).max())
        del ref, tol
        H, Nq, dh = q.shape[-3:]
        Nk = k.shape[-2]
        BH = q.numel() // (Nq * dh)
        q4, k4, v4 = (x.reshape(-1, H, *x.shape[-2:]) for x in (q, k, v))
        bias = torch.where(mask.reshape(-1, Nk), 0.0, -1e9).to(
            torch.bfloat16)[:, None, None, :]

        def kernel():
            A.attention_cuda(q, k, v, mask, scale)

        def sdpa():
            F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias,
                                           scale=scale)

        spin = SPIN_CYCLES
        row = dict(shape=name, err_over_bound=over,
                   ms=time_ms(torch, kernel, args.reps, spin=spin),
                   events_ms=time_ms(torch, kernel, args.reps),
                   sdpa_ms=time_ms(torch, sdpa, args.reps, spin=spin),
                   sdpa_events_ms=time_ms(torch, sdpa, args.reps))
        row["bound_ms"] = 4.0 * BH * Nq * Nk * dh / 989e12 * 1e3
        if hasattr(A, "split_plan"):
            q_tile, row["key_tile"], splits = A.split_plan(BH, Nq, Nk)
            row["splits"] = splits
            row["ctas"] = -(-Nq // q_tile) * BH * splits
            if args.sweep_splits and splits > 1:
                plan, row["sweep_ms"] = A.split_plan, {}
                for S in (1, 2, 4, 8):
                    A.split_plan = lambda *_, S=S: (q_tile, row["key_tile"], S)
                    row["sweep_ms"][S] = time_ms(torch, kernel, args.reps,
                                                 spin=spin)
                A.split_plan = plan
        # Host time per call: the median of 5 rounds of back-to-back calls.
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
                          ptxas=ptxas, launches=_build.LAUNCHES["attention"],
                          shapes=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
