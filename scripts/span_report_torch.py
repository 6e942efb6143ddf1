"""The program's own account of a benchmark cell's steps: what tracing
costs when it records, the host's self and blocked time by span, and every
synchronisation of the chunk and BA path.

    python3 scripts/span_report_torch.py --workload strict.fleet64 \
        --seed 7100000001 --rounds 3 --out chiprun_out/SPANS_TORCH.json

Sets the cell up as `benchmark/run.py` does (`benchmark.harness.Program`:
kernels, weights, the drive rendered on the card, the bootstrap and one
warm-up step), then runs `--rounds` rounds of `--steps` steps without
recording and `--steps` steps under `tracing.recording()`, in turns (the
first half of the rounds starts without it, the rest with it), each pair
of halves timed from a synchronised card to a synchronised card. Recording
turns PyTorch's sync debug mode to "warn", so every implicit
synchronisation is counted on the span it falls in, with the package's
file and line; a 0-d `.item()` in a span of its own after the steps
checks that the counter counts (`control_syncs`, 1).

Writes `--out`: the card, fps with recording off and on per round, and per
recorded round the span summary a step (calls, host wall / self / blocked
ms, explicit reads, implicit synchronisations), the synchronisation sites,
and how a step's host time divides: self time in spans, blocked time in
reads, host time outside every span, and the wait for the card when the
steps had been issued. `--trace` writes the last recorded round's spans
as a Chrome trace beside it. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _timed(program, steps, sync):
    """(seconds of `steps` steps to a synchronised card, seconds spent in
    the final synchronisation)."""
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        program.step()
    t1 = time.perf_counter()
    sync()
    t2 = time.perf_counter()
    return t2 - t0, t2 - t1


def _per_step(summary, steps):
    return {name: {k: v / steps for k, v in s.items()}
            for name, s in sorted(summary.items(),
                                  key=lambda kv: -kv[1]["self_ms"])}


def _split(rec, steps, wall_s, wait_s):
    """How the recorded steps' host time divides, in ms a step."""
    roots = [r for r in rec.records if r.parent < 0]
    in_spans = sum(r.end_ns - r.start_ns for r in roots) / 1e6
    self_ms = sum(r.self_ns for r in rec.records) / 1e6
    blocked = sum(r.blocked_ns for r in rec.records) / 1e6
    wall = 1e3 * wall_s
    return dict(wall_ms=wall / steps, span_self_ms=self_ms / steps,
                span_blocked_ms=blocked / steps,
                outside_spans_ms=(wall - 1e3 * wait_s - in_spans) / steps,
                final_wait_ms=1e3 * wait_s / steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="strict.fleet64")
    ap.add_argument("--seed", type=int, default=7100000001)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/SPANS_TORCH.json")
    ap.add_argument("--trace", default=None,
                    help="write the last recorded round's spans here")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from gl_slam_tpu_torch import tracing

    if not torch.cuda.is_available():
        print("span_report_torch: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    harness.require_program(cell["config"])
    t0 = time.perf_counter()
    drive = harness.Drive(cell, args.seed, dev)
    program = harness.Program(cell, drive, args.seed, dev)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    frames = drive.S * drive.T * args.steps

    def sync():
        torch.cuda.synchronize(dev)

    rounds = []
    for k in range(args.rounds):
        row = dict(round=k)
        for on in ((False, True) if k < (args.rounds + 1) // 2
                   else (True, False)):
            if not on:
                wall, wait = _timed(program, args.steps, sync)
                row["off_fps"] = frames / wall
                row["off_final_wait_ms"] = 1e3 * wait / args.steps
                continue
            with tracing.recording() as rec:
                wall, wait = _timed(program, args.steps, sync)
                # the counter's own check: one implicit synchronisation
                with tracing.span("control.item"):
                    torch.zeros((), device=dev).item()
            row["control_syncs"] = rec.summary()["control.item"]["syncs"]
            rec.records.pop()
            row["on_fps"] = frames / wall
            row["spans_per_step"] = _per_step(rec.summary(), args.steps)
            row["host_split_per_step"] = _split(rec, args.steps, wall, wait)
            # [span or "(outside)", file:line, count]
            row["sync_sites"] = [[span, site, n] for (span, site), n in
                                 sorted(rec.sync_sites.items())
                                 if span != "control.item"]
            row["records"] = len(rec.records)
            if args.trace:
                rec.export(args.trace)
        rounds.append(row)
        print(f"round {k}: off {row['off_fps']:.3f} fps, on "
              f"{row['on_fps']:.3f} fps, {row['records']} spans, "
              f"{len(row['sync_sites'])} sync sites", file=sys.stderr,
              flush=True)

    off = [r["off_fps"] for r in rounds]
    on = [r["on_fps"] for r in rounds]
    out = dict(workload=args.workload, seed=args.seed,
               card=harness.card_line(), torch=torch.__version__,
               setup_s=setup_s, steps=args.steps,
               frames_per_half=frames, off_fps_median=statistics.median(off),
               on_fps_median=statistics.median(on),
               on_over_off=statistics.median(a / b for a, b in zip(on, off)),
               rounds=rounds)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "rounds"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
