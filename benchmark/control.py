"""The readings that the check's limits are set from, in one process.

For each of the program's seeds: the cell's drive, the program set up and
run for `--steps` chunk steps at the cell's own load, and every number the
check compares, with `ba_start_gap` beside them: the reading of a BA pass
that changes nothing. For each of the control's seeds (a subset of the
program's, so the control reads the same frames and BA windows): the
plain reference put in the program's place one precision below the
configuration's (the networks with every product rounded to fp8 e4m3,
below their bf16; the BA's LM in TF32, below its float32), compared with
the full-precision reference the same way, and the check's verdict on
those numbers, which has to be false. The benchmark's own runs do not
run this.

    python benchmark/control.py --workload strict.fleet64 \
        --seeds 11,12,...,22 --control-seeds 11,12,13 --steps 1 \
        --out control.strict.fleet64.json
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload: str, seeds, control_seeds, steps: int,
             bench_json=None, bench_dir=None, require_cuda: bool = True,
             log=print) -> dict:
    """{"program": {seed: numbers}, "control": {seed: numbers}}; each
    control entry has the check's verdict on it under `correct`."""
    import torch
    from benchmark import check, harness, runner
    bench_dir = bench_dir or harness.BENCH_DIR
    cell = harness.load_cell(workload, bench_json, bench_dir)
    dev = runner._device(cell, require_cuda)
    out = {"program": {}, "control": {}}
    for seed in seeds:
        t0 = time.perf_counter()
        drive = harness.Drive(cell, seed, dev)
        program = harness.Program(cell, drive, seed, dev)
        for _ in range(steps):
            program.step()
        col = check.collect(program)
        del program
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        K = drive.scene.K.astype("float64")
        nums = check.pose_numbers(col, drive)
        nums.update(check.ba_numbers(col, cell, K, dev))
        nums.update(check.feature_numbers(
            check.reference_features(cell, drive, col, dev)))
        out["program"][seed] = nums
        log(f"program seed {seed}: {json.dumps(nums)} "
            f"[{time.perf_counter() - t0:.1f} s]")
        if seed in control_seeds:
            q = check.feature_numbers(
                check.reference_features(cell, drive, col, dev, fp8=True))
            q.update(check.ba_numbers(col, cell, K, dev, tf32=True))
            # the control replaces what the check recomputes; the poses
            # stay the program's
            q["correct"] = check.verdict(dict(nums, **q), cell["config"])[0]
            out["control"][seed] = q
            log(f"control seed {seed}: {json.dumps(q)}")
        del drive
        gc.collect()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",")]
    cseeds = {int(x) for x in args.control_seeds.split(",")}
    if not cseeds <= set(seeds):
        print("control seeds must be among the seeds", file=sys.stderr)
        return 2
    res = readings(args.workload, seeds, cseeds, args.steps)
    import torch
    res["card"] = torch.cuda.get_device_name(0)
    from benchmark import harness
    res["card_line"] = harness.card_line()
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    for name in ("kpt_miss", "desc_gap", "refine_gap_px", "ba_cost_gap"):
        lo = max(v[name] for v in res["program"].values())
        hi = min(v[name] for v in res["control"].values())
        print(f"{args.workload} {name}: program max {lo}, control min {hi}")
    start = min(v["ba_start_gap"] for v in res["program"].values())
    print(f"{args.workload} ba_start_gap (a pass that changes nothing): "
          f"min {start}")
    verdicts = [v["correct"] for v in res["control"].values()]
    print(f"{args.workload} control verdicts: {verdicts}")
    return 0 if not any(verdicts) else 1


if __name__ == "__main__":
    sys.exit(main())
