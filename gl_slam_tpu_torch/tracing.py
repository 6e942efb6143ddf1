"""Per-stage timing, structured per-frame metrics and profiler capture.

Counterpart of gl_slam_tpu/tracing.py. `StageTimer` accumulates host wall
time per pipeline stage and, with `block=True`, waits for the stream of a
given CUDA tensor at the end of each stage, so that the stage's device
work is inside its time (for profiling only: the wait stalls the host).
Otherwise it never synchronises, and a stage's time is the time to issue
its work. `MetricsRecorder` keeps one row per frame and writes them as
JSON lines. `profiler_trace` wraps a region in `torch.profiler` and
exports a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


class StageTimer:
    """Accumulates wall time per pipeline stage.

    `block=True` waits, at the end of a stage given `sync_on` (a CUDA
    tensor), for the work queued on that tensor's stream, so that the
    measurement is the stage's cost rather than its issue time. Use it
    only when profiling, never on the throughput path."""

    def __init__(self, block: bool = False):
        self.block = block
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if self.block and torch.is_tensor(sync_on) and sync_on.is_cuda:
            torch.cuda.current_stream(sync_on.device).synchronize()
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(v, 4),
                    "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3),
                    "count": self.counts[k]}
                for k, v in sorted(self.totals.items())}


class MetricsRecorder:
    """Structured per-frame metrics: one row per frame, numbers as floats
    (a device scalar is read to the host here), anything else as given."""

    def __init__(self):
        self.frames: List[dict] = []

    def record(self, frame_idx: int, **kv):
        row = {"frame": int(frame_idx)}
        for k, v in kv.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self.frames.append(row)

    def to_jsonl(self, path: str):
        with open(path, "w") as f:
            for row in self.frames:
                f.write(json.dumps(row) + "\n")

    def last(self) -> Optional[dict]:
        return self.frames[-1] if self.frames else None


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """`torch.profiler` capture of a region (host and, where a card is
    present, device activity), exported to `<logdir>/trace.json` as a
    Chrome trace. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
