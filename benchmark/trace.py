"""Reading a torch.profiler trace into the numbers the per-layer
metrics take.

A frozen copy of the port's raw-record reader (the profiler's
`kineto_results.events()`, read directly: building the Python event tree
is slow at the 10^5-10^6 records of a window), with its arithmetic: device
busy time, kernel-launch calls, the device span of each `record_function`
range, device time by kernel name, and the idle gaps named by the
innermost range the host was in.

The reader works on plain records (`Record`), so it is tested on
synthetic event lists; `records_of(prof)` makes them from a profile.
"""

from __future__ import annotations

import bisect
from typing import Iterable, NamedTuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    on_device: bool          # a device activity (kernel, copy, set)
    annotation: bool         # a record_function range


class TraceError(RuntimeError):
    """The trace cannot give the numbers: no device records."""


def records_of(prof) -> list:
    """Records of a finished torch.profiler profile."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        out.append(Record(e.name(), e.start_ns(), e.end_ns(),
                          e.device_type() == cuda, e.is_user_annotation()))
    return out


class Summary(NamedTuple):
    busy_s: float            # device activity, overlaps merged
    launches: int            # kernel-launch calls on the host
    span_s: dict             # range name -> summed device span (s)
    kernel_s: dict           # device activity name -> summed time (s)
    kernel_n: dict           # device activity name -> count
    gaps_s: dict             # innermost host range -> summed idle (s)


def summarize(records: Iterable[Record]) -> Summary:
    """Busy time, launches, spans, kernel times and idle gaps of a
    trace. Raises TraceError when it holds no device activity."""
    acts, host_ranges = [], []
    span_s, kernel_s, kernel_n = {}, {}, {}
    launches = 0
    for r in records:
        dur = (r.end_ns - r.start_ns) / 1e9
        if r.annotation:
            if r.on_device:
                span_s[r.name] = span_s.get(r.name, 0.0) + dur
            else:
                host_ranges.append((r.start_ns, r.end_ns, r.name))
        elif r.on_device:
            acts.append((r.start_ns, r.end_ns))
            kernel_s[r.name] = kernel_s.get(r.name, 0.0) + dur
            kernel_n[r.name] = kernel_n.get(r.name, 0) + 1
        elif r.name in LAUNCH_CALLS:
            launches += 1
    if not acts:
        raise TraceError("the profiler recorded no device activity")
    acts.sort()
    busy_ns, gaps = 0, []
    cur_s, cur_e = acts[0]
    for s, e in acts[1:]:
        if s > cur_e:
            busy_ns += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_ns += cur_e - cur_s
    if busy_ns <= 0:
        raise TraceError("the profiler's device records have no duration")
    return Summary(busy_ns / 1e9, launches, span_s, kernel_s, kernel_n,
                   _name_gaps(gaps, host_ranges))


def _segments(ranges):
    """Disjoint (start, end, name) segments labelled by the innermost host
    range (the latest-starting one that still covers the point)."""
    bounds = sorted({t for s, e, _ in ranges for t in (s, e)})
    if not bounds:
        return [], []
    events = sorted(ranges)
    starts, labels, stack, j = [], [], [], 0
    for a in bounds[:-1]:
        while j < len(events) and events[j][0] <= a:
            stack.append(events[j])
            j += 1
        stack = [x for x in stack if x[1] > a]
        starts.append(a)
        labels.append(max(stack)[2] if stack else None)
    return starts, labels


def _name_gaps(gaps, host_ranges) -> dict:
    """Idle seconds by the innermost host range at each gap's midpoint
    ("(outside)" where the host was in none)."""
    starts, labels = _segments(host_ranges)
    out = {}
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = labels[i] if i >= 0 else None
        name = name or "(outside)"
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def device_time(summary: Summary, needles) -> tuple:
    """(seconds, count) of the device activities whose name contains any
    of `needles`."""
    t = n = 0
    for name, s in summary.kernel_s.items():
        if any(k in name for k in needles):
            t += s
            n += summary.kernel_n[name]
    return t, n


def top(d: dict, k: int = 10) -> list:
    """The k largest [name, value] pairs of `d`, largest first."""
    return [[name[:120], v] for name, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:k]]
