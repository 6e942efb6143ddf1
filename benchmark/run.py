"""The benchmark of gl_slam_tpu_torch: one run of one cell.

    python benchmark/run.py --workload strict.fleet64 --seed 7 --seconds 51 \
        --trace 0

Sets up the cell (kernels built into the package's csrc/build/, the
committed weights loaded, the drive rendered and staged on the card, every
stream bootstrapped, one warm-up chunk and BA pass), measures for
`--seconds` seconds (with `--trace 1` instead: the traffic's `trace_steps`
steps timed without the profiler, then as many profiled), checks what the window produced against the
plain reference, and prints the result as the last line of standard
output: one JSON object with `correct`, `attempted`, `failed`, `metrics`,
`device` (and with `--trace 1` `breakdown`), then `checks`, each compared
number beside its limit. Exits non-zero, printing no result, without a
CUDA card, with too few cards, when a file of the benchmark or the program
is missing, or when JAX or the JAX package is loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# kernel and extension caches at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, ".bench_cache", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, ".bench_cache", "triton"))
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        from benchmark import harness, runner
    except ImportError as e:
        print(f"benchmark: cannot import the harness: {e}", file=sys.stderr)
        return 3
    try:
        result = runner.execute(args.workload, args.seed, args.seconds,
                                bool(args.trace), T_PROCESS)
    except (harness.SetupError, ImportError, FileNotFoundError) as e:
        print(f"benchmark: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    except Exception as e:             # a run that fails prints no result
        import traceback
        traceback.print_exc()
        print(f"benchmark: the run failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print("benchmark: the process holds " + ", ".join(bad),
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
