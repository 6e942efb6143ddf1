"""A run of a cell from set-up to its result line.

`execute` is the whole run that `run.py` makes; tests call it on the CPU
at a tiny size (`require_cuda=False`), with the program broken underneath
where they look for the check to fail.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Optional

from . import check, flops, harness, trace

def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _device(cell: dict, require_cuda: bool):
    import torch
    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available():
        if require_cuda:
            raise harness.SetupError("torch.cuda.is_available() is false")
        return torch.device("cpu")
    if torch.cuda.device_count() < chips:
        raise harness.SetupError(f"{torch.cuda.device_count()} cards, the "
                                 f"cell needs {chips}")
    return torch.device("cuda", 0)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(workload: str, seed: int, seconds: float, traced: bool,
            t_process: float, bench_json: Optional[str] = None,
            bench_dir: str = harness.BENCH_DIR,
            require_cuda: bool = True) -> dict:
    """The result of one run (the keys of the result line, in order)."""
    import torch
    cell = harness.load_cell(workload, bench_json, bench_dir)
    harness.require_program(cell["config"])
    dev = _device(cell, require_cuda)
    t_drive = time.perf_counter()
    drive = harness.Drive(cell, seed, dev)
    _sync(dev)
    t_program = time.perf_counter()
    program = harness.Program(cell, drive, seed, dev)
    _sync(dev)
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    log(f"set-up {setup_s:.3f} s: {drive.S} streams, chunk {drive.T}, "
        f"{drive.F} frames staged; start-up and the card "
        f"{t_drive - t_process:.3f} s, the drive {t_program - t_drive:.3f} s, "
        f"the program (build, weights, bootstrap, warm-up step) "
        f"{t_window - t_program:.3f} s")
    S, T = drive.S, drive.T

    summary, prof = None, None
    t0 = time.perf_counter()
    if traced:
        # the traffic's trace_steps steps timed without the profiler (the
        # profiler slows the host), then as many under it
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        n_steps = cell["traffic"]["trace_steps"]
        for _ in range(n_steps):
            program.step()
        _sync(dev)
        plain_s = time.perf_counter() - t0
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                program.step()
            _sync(dev)
            window_s = time.perf_counter() - t0
        steps = n_steps
        log(f"untraced steps {plain_s:.3f} s, traced steps {window_s:.3f} s "
            f"({n_steps} steps each)")
    else:
        steps, ended = 0, []
        while True:
            program.step()
            steps += 1
            ended.append(time.perf_counter() - t0)
            if ended[-1] >= seconds:
                break
        _sync(dev)
        window_s = time.perf_counter() - t0
        log("steps ended on the host at (s): "
            + " ".join(f"{x:.3f}" for x in ended))
    frames = S * T * steps
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    bad = harness.forbidden_modules()
    if bad:
        raise harness.SetupError("the process holds " + ", ".join(bad))
    log(f"window {window_s:.3f} s: {steps} steps, {frames} frames, "
        f"{frames / window_s:.4f} frames/s; peak {peak} bytes")
    if dev.type == "cuda":
        log(f"card after the window (name, power limit, clocks, draw, "
            f"temperature): {harness.card_line()}")

    if traced:
        t1 = time.perf_counter()
        summary = trace.summarize(trace.records_of(prof)) \
            if dev.type == "cuda" else None
        del prof
        log(f"trace read in {time.perf_counter() - t1:.3f} s")

    # the check: copy what is judged, free the program, run the reference
    t1 = time.perf_counter()
    col = check.collect(program)
    window_frames = col["ok"][:, T:]              # chunk 0 is the warm-up
    failed = int((~window_frames).sum())
    K = drive.scene.K.astype("float64")
    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.pose_numbers(col, drive)
    numbers.update(check.ba_numbers(col, cell, K, dev))
    numbers.update(check.feature_numbers(
        check.reference_features(cell, drive, col, dev)))
    correct, checks = check.verdict(numbers, cell["config"])
    log(f"check run in {time.perf_counter() - t1:.3f} s")
    for name in ("desc_gap_max", "refine_gap_max", "refine_rows",
                 "ba_start_gap", "ba_ref_iters", "ate_m_median",
                 "ate_worst_streams"):
        log(f"beside the check: {name} {numbers[name]}")

    shape = flops.cell_shape(cell["config"])
    if traced:
        ctx = dict(summary=summary, frames=frames, window_s=window_s,
                   plain_s=plain_s, shape=shape, streams=S, device=dev.type)
        metrics = {}
        for m in cell["per_layer"]:
            v = harness.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(fps=frames / window_s, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    device = dict(platform="gpu" if dev.type == "cuda" else "cpu",
                  kind=torch.cuda.get_device_name(dev)
                  if dev.type == "cuda" else "cpu",
                  count=cell["cell"]["chips"], memory_peak_bytes=peak)
    attempted = S * T * (2 * steps if traced else steps)
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=device)
    if traced and summary is not None:
        device.update(busy_s=summary.busy_s, window_s=window_s)
        result["breakdown"] = dict(device_ops=trace.top(summary.kernel_s),
                                   idle_gaps=trace.top(summary.gaps_s))
    for name, (v, lim) in checks.items():
        log(f"check {name}: {v} (limit {lim})")
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
