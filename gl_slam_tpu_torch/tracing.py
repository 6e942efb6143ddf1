"""Spans of the port's layers, the host's reads of the card, and the
per-frame metrics file.

`span(name)` is the one way the port marks a layer. It has three states:

  * off (no `recording()` and no active `torch.profiler`): one flag check
    and a shared null context; no profiler range, no clock read, nothing
    allocated. This is what a throughput run executes.
  * under an active profiler: a `record_function` range of the same name,
    so the device trace sees the layer (the idle gaps the host spent inside
    it, and the device span of the kernels it issued: the profiler gives a
    kernel to the innermost range only, so a child range's kernels are not
    in its parent's span). `span(..., profile=False)` opens no range.
  * under `recording()`: besides, an in-memory record with the name, the
    parent span, host start and end, the step id (the index of the
    enclosing `chunk` span), the frame index in the chunk (`at_frame`),
    the stream count, and the span's host reads, blocked host time and
    implicit synchronisations.

Host timestamps are Unix-epoch nanoseconds (`time.time_ns`, CLOCK_REALTIME),
the clock `torch.profiler` stamps its own host records with, so a record
lines up with its profiler range and every idle gap of a device trace can
be put down to what the host was doing.

`host_read(x, name)` is the one funnel for an explicit device-to-host read
on the tracker's path: a span `name` around `x.cpu()`, which charges one
read and the time the host was blocked to that span. While recording
with `syncs` (the default), the implicit synchronisations that
`torch.cuda.set_sync_debug_mode("warn")` reports (a 0-d `.item()`, a
boolean mask, `nonzero`, ...) are counted on the innermost open span,
with the package's file and line that issued them (`Recorder.sync_sites`).

`Recorder.summary()` gives, per span name, its calls, host wall ms, self ms
(wall minus the children's wall, minus blocked), blocked ms, reads and
synchronisations; `Recorder.stages()` the command line's per-stage report
in the format of the JAX package's stage timer; `Recorder.export()`
Chrome-trace events that load in one timeline with `torch.profiler`'s own
export.

`MetricsRecorder` keeps one row per frame and writes them as JSON lines
(the command line's `metrics.jsonl`).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
import warnings
from collections import Counter
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_clock = time.time_ns          # the profiler's host clock (Unix-epoch ns)
_REC: Optional["Recorder"] = None
_NULL = contextlib.nullcontext()
_PKG = os.path.dirname(os.path.abspath(__file__))
_SYNC_WARNING = "called a synchronizing CUDA operation"

# The first profiler range of a process takes ~1 ms to return after the
# profiler stamps its start; one opened here, where no profiler runs,
# keeps a later span's record within tens of us of its range.
with record_function("tracing"):
    pass


class Record:
    """One span as the recorder saw it. Times are host ns on `_clock`."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "step", "frame",
                 "streams", "reads", "blocked_ns", "syncs", "child_ns")

    def __init__(self, name, parent, start_ns, step, frame, streams):
        self.name, self.parent, self.start_ns = name, parent, start_ns
        self.end_ns = start_ns
        self.step, self.frame, self.streams = step, frame, streams
        self.reads = self.blocked_ns = self.syncs = self.child_ns = 0

    @property
    def self_ns(self) -> int:
        return self.end_ns - self.start_ns - self.child_ns - self.blocked_ns


class Recorder:
    """The records of one `recording()` region, in the order spans opened.

    `step` counts the spans opened with `step=True` (the chunk calls),
    from 0; `frame` is the value of the last `at_frame` inside the
    enclosing span, None elsewhere; `streams` is inherited from the
    innermost span that set it."""

    def __init__(self):
        self.records: List[Record] = []
        # (innermost span or "(outside)", "file:line") -> synchronisations
        self.sync_sites: Counter = Counter()
        self._stack: List[int] = []
        self._step = -1
        self._frame: Optional[int] = None
        self._streams: Optional[int] = None
        self._in_read = False

    def _open(self, name, streams, step):
        if step:
            self._step += 1
            self._frame = None
        parent = self._stack[-1] if self._stack else -1
        ctx = (self._frame, self._streams)
        if streams is not None:
            self._streams = streams
        self.records.append(Record(name, parent, _clock(), self._step,
                                   self._frame, self._streams))
        self._stack.append(len(self.records) - 1)
        return ctx

    def _close(self, ctx):
        r = self.records[self._stack.pop()]
        r.end_ns = _clock()
        if r.parent >= 0:
            self.records[r.parent].child_ns += r.end_ns - r.start_ns
        self._frame, self._streams = ctx

    def _sync_warned(self, frame) -> None:
        """An implicit synchronisation: count it on the innermost span,
        with the package's innermost file:line on the Python stack (else
        the caller's)."""
        if self._in_read:
            return
        site = caller = None
        while frame is not None and site is None:
            path = frame.f_code.co_filename
            here = os.path.basename(path) in ("tracing.py", "warnings.py")
            if caller is None and not here:
                caller = f"{path}:{frame.f_lineno}"
            if path.startswith(_PKG) and not here:
                site = (f"{os.path.relpath(path, os.path.dirname(_PKG))}:"
                        f"{frame.f_lineno}")
            frame = frame.f_back
        site = site or caller or "?"
        if not self._stack:
            self.sync_sites[("(outside)", site)] += 1
            return
        r = self.records[self._stack[-1]]
        r.syncs += 1
        self.sync_sites[(r.name, site)] += 1

    # -- reports -----------------------------------------------------------
    def summary(self) -> Dict[str, dict]:
        """Per span name: calls, host wall / self / blocked ms, reads and
        implicit synchronisations, summed over its records."""
        out: Dict[str, dict] = {}
        for r in self.records:
            s = out.setdefault(r.name, dict(calls=0, wall_ms=0.0, self_ms=0.0,
                                            blocked_ms=0.0, reads=0,
                                            syncs=0))
            s["calls"] += 1
            s["wall_ms"] += (r.end_ns - r.start_ns) / 1e6
            s["self_ms"] += r.self_ns / 1e6
            s["blocked_ms"] += r.blocked_ns / 1e6
            s["reads"] += r.reads
            s["syncs"] += r.syncs
        return out

    def stages(self, names=None) -> Dict[str, dict]:
        """The command line's `stages`: the host wall time of the spans
        opened outside any other span, by name, as the JAX package's stage
        timer reports it (`total_s`, `mean_ms`, `count`, sorted by name).
        `names` picks the spans (default: all of them)."""
        total: Dict[str, int] = {}
        count: Dict[str, int] = {}
        for r in self.records:
            if r.parent < 0 and (names is None or r.name in names):
                total[r.name] = total.get(r.name, 0) + r.end_ns - r.start_ns
                count[r.name] = count.get(r.name, 0) + 1
        return {k: {"total_s": round(total[k] / 1e9, 4),
                    "mean_ms": round(total[k] / 1e6 / count[k], 3),
                    "count": count[k]}
                for k in sorted(total)}

    def export(self, path: str, beside: Optional[str] = None) -> None:
        """Chrome-trace events of the records (one complete event each,
        on a thread of their own, with the record's ids and counts as
        arguments). `beside`: a `torch.profiler` Chrome export whose
        events are written into the same file, on its time base, so that
        both load as one timeline."""
        events, base = [], None
        if beside is not None:
            with open(beside) as f:
                doc = json.load(f)
            base = int(doc.get("baseTimeNanoseconds", 0))
            events = doc["traceEvents"]
        else:
            doc = {"displayTimeUnit": "ms"}
        if base is None:
            first = min((r.start_ns for r in self.records), default=0)
            base = first - first % 10 ** 9
        pid, tid = os.getpid(), 1
        events.append(dict(ph="M", name="thread_name", pid=pid, tid=tid,
                           args=dict(name="gl_slam_tpu_torch spans")))
        for r in self.records:
            args = dict(step=r.step, frame=r.frame, streams=r.streams,
                        self_ms=r.self_ns / 1e6,
                        blocked_ms=r.blocked_ns / 1e6, reads=r.reads,
                        syncs=r.syncs,
                        parent=self.records[r.parent].name
                        if r.parent >= 0 else None)
            events.append(dict(ph="X", cat="span", name=r.name, pid=pid,
                               tid=tid, ts=(r.start_ns - base) / 1e3,
                               dur=(r.end_ns - r.start_ns) / 1e3, args=args))
        doc["traceEvents"] = events
        doc["baseTimeNanoseconds"] = base
        with open(path, "w") as f:
            json.dump(doc, f)


class _Span:
    __slots__ = ("name", "streams", "step", "profile", "_rf", "_ctx")

    def __init__(self, name, streams, step, profile=True):
        self.name, self.streams, self.step = name, streams, step
        self.profile = profile
        self._rf = self._ctx = None

    def __enter__(self):
        if self.profile and _profiler._is_profiler_enabled:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        if _REC is not None:
            self._ctx = _REC._open(self.name, self.streams, self.step)
        return self

    def __exit__(self, *exc):
        if self._ctx is not None and _REC is not None:
            _REC._close(self._ctx)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str, *, streams: Optional[int] = None, step: bool = False,
         profile: bool = True):
    """A context that marks the layer `name` (see the module's doc).
    `streams`: the stream count of the work inside; `step=True` starts a
    new step id (the chunk call).

    `profile=False` records the span but opens no profiler range. It is a
    stopgap: the profiler gives each kernel to the innermost range only,
    and the benchmark's trace reader sees no nesting, so a range here
    would take the kernels of the benchmark's own ranges around the same
    call (`bench.chunk`, `bench.ba`) and leave their metrics unread. The
    spans that hold such a call's work (`chunk`, `prologue`, `track`, the
    multi-stream `backend.ba`) pass it until the benchmark reads those
    spans in place of its own ranges; then the option goes."""
    if _REC is None and not (profile and _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, streams, step, profile)


def at_frame(i: int) -> None:
    """The frame index in the chunk of the spans opened from here to the
    end of the enclosing span (recording only)."""
    if _REC is not None:
        _REC._frame = i


def host_read(x: torch.Tensor, name: str) -> torch.Tensor:
    """`x.cpu()` inside a span `name`, which is charged one read and the
    host time the read took (the wait for the card included)."""
    with span(name):
        rec = _REC
        if rec is None:
            return x.cpu()
        rec._in_read = True
        t0 = _clock()
        try:
            out = x.cpu()
        finally:
            rec._in_read = False
        r = rec.records[rec._stack[-1]]
        r.blocked_ns += _clock() - t0
        r.reads += 1
    return out


@contextlib.contextmanager
def recording(syncs: bool = True):
    """Record every span opened inside (on this thread's spans: the port
    opens them on the host thread that drives the card) and, with `syncs`
    where CUDA is initialised, count the implicit synchronisations: that
    turns CUDA's process-wide sync debug mode to "warn" and hooks
    `warnings.showwarning` until the region ends. `syncs=False` records
    the spans' host times and reads only. Yields the Recorder. Inside
    another recording the region is the new recorder's alone; the outer
    one records again after it."""
    global _REC
    outer, rec = _REC, Recorder()
    with contextlib.ExitStack() as stack:
        if syncs and torch.cuda.is_available() and \
                torch.cuda.is_initialized():
            stack.enter_context(_counting_syncs(rec))
        _REC = rec
        try:
            yield rec
        finally:
            _REC = outer


@contextlib.contextmanager
def _counting_syncs(rec: Recorder):
    """CUDA's sync debug mode at "warn", its warnings counted on `rec`
    (from this thread) instead of shown."""
    owner = threading.get_ident()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=".*" + _SYNC_WARNING)
        shown = warnings.showwarning

        def hook(message, category, filename, lineno, file=None, line=None):
            if _SYNC_WARNING in str(message) and \
                    threading.get_ident() == owner:
                rec._sync_warned(sys._getframe(1))
                return
            shown(message, category, filename, lineno, file, line)

        warnings.showwarning = hook
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)


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
