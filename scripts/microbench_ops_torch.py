"""Micro-bench of the launch floor and of single ops on the port's
per-frame path, on the card (the counterpart of scripts/microbench_ops.py).

First the dispatch floor: one trivial op (`x + 1` on 8 floats), host us a
call. Then the hot ops of microbench_ops.py at its sizes, each as the port
writes it: `topk_stable` (the port's `lax.top_k`) of 65536 -> 2048 / 1024 /
256, the newest-first cumsum select of 65536 -> 2048 / 1024
(`select_newest_ids_cumsum`), the scatter-add histogram 32k -> 512, the
bool scatter 120k -> 65536, the descriptor gather 2048 x 256 from 65536,
a stable argsort of 65536, and the two point-table scatters (2048 x 3 and
2048 x 256 bf16 into 65536-row tables); the scatters and the gather go
through `slam/state._scatter` / `_gather`, the port of JAX's
`.at[].set/add(mode='drop')` and `x[idx]`.

Per op: host ms a call (n calls timed by `perf_counter`, a synchronisation
after the last), the same above the floor, device ms a call (CUDA events
around n calls queued behind a spin kernel, chip_smoke.time_ms) and the
kernel launches a call makes (torch.profiler). The host time above the
floor estimates what the op adds to a frame where the host issues work
slower than the card runs it.

    python3 scripts/microbench_ops_torch.py [--json PATH] [--n 30]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

P, N, KMAX = 65536, 2048, 512


def ops(dev) -> list:
    """(name, fn) of every measured op, the floor first, on `dev`."""
    import torch

    from gl_slam_tpu_torch.ops.select import (select_newest_ids_cumsum,
                                              topk_stable)
    from gl_slam_tpu_torch.slam.state import _gather, _scatter

    gen = torch.Generator(device=dev).manual_seed(0)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    x8 = torch.ones(8, device=dev)
    prio = randint(-1, 512, (P,))
    mask = prio > 300
    hist_ids = randint(0, KMAX, (N * 16,))
    flat = randint(0, P, (60 * N,))
    desc = torch.randn((P, 256), generator=gen, device=dev).to(torch.bfloat16)
    cand = randint(0, P, (N,))
    pts = torch.randn((N, 3), generator=gen, device=dev)
    descf = torch.randn((N, 256), generator=gen, device=dev).to(
        torch.bfloat16)
    table3 = torch.zeros((P, 3), device=dev)
    table256 = torch.zeros((P, 256), dtype=torch.bfloat16, device=dev)
    zeros_k = torch.zeros((KMAX,), dtype=torch.int32, device=dev)
    zeros_p = torch.zeros((P,), dtype=torch.bool, device=dev)
    return [
        ("dispatch floor (1-op)", lambda: x8 + 1.0),
        ("top_k 65536 -> 2048", lambda: topk_stable(prio, 2048)),
        ("top_k 65536 -> 1024", lambda: topk_stable(prio, 1024)),
        ("top_k 65536 -> 256", lambda: topk_stable(prio, 256)),
        ("cumsum-select 65536 -> 2048",
         lambda: select_newest_ids_cumsum(mask, 2048)),
        ("cumsum-select 65536 -> 1024",
         lambda: select_newest_ids_cumsum(mask, 1024)),
        ("scatter-add hist 32k -> 512",
         lambda: _scatter(zeros_k, hist_ids, torch.ones_like(hist_ids),
                          accumulate=True)),
        ("scatter-set bool 120k -> 65536",
         lambda: _scatter(zeros_p, flat, True)),
        ("gather 2048x256 desc", lambda: _gather(desc, cand)),
        ("argsort 65536", lambda: torch.argsort(prio, stable=True)),
        ("scatter 2048x3 into 65536x3", lambda: _scatter(table3, cand, pts)),
        ("scatter 2048x256 into 65536x256",
         lambda: _scatter(table256, cand, descf)),
    ]


def bench(name: str, fn, n: int, dev, floor_ms=None) -> dict:
    """One op's row: host ms a call (and above `floor_ms`), device ms a
    call and launches a call (on a card; None on the CPU)."""
    import torch
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / n * 1e3
    row = dict(host_ms=host, above_floor_ms=None if floor_ms is None
               else host - floor_ms, device_ms=None, launches=None)
    if dev.type == "cuda":
        import chip_smoke
        from profile_stages_torch import _profile_one
        row["device_ms"] = chip_smoke.time_ms(fn, reps=n, warmup=0)
        row["launches"] = _profile_one(fn)[0]
    extra = "" if floor_ms is None else \
        f" ({row['above_floor_ms'] * 1e3:8.1f} us above the floor)"
    dev_txt = "" if row["device_ms"] is None else \
        f", device {row['device_ms'] * 1e3:8.1f} us, {row['launches']} " \
        "launches"
    print(f"{name:>32}: host {host * 1e3:8.1f} us{extra}{dev_txt}",
          flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=30, help="calls an op")
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without CUDA)")
    args = ap.parse_args(argv)

    from gl_slam_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import chip_smoke
        card = chip_smoke.card_line()
    else:
        card = "cpu"
    print(f"card: {card}", flush=True)
    rows, floor = {}, None
    for name, fn in ops(dev):
        rows[name] = bench(name, fn, args.n, dev, floor)
        if floor is None:
            floor = rows[name]["host_ms"]
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"backend": dev.type, "card": card, "n": args.n,
                       "ops": rows}, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
