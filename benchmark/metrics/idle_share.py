"""The card's idle share at the untraced pace: 1 - (device busy time a
frame in the profiled steps, overlaps merged) / (wall time a frame of the
as many untraced steps run just before them). The profiler slows the
host, so the traced window's own idle share (`device.busy_s` over
`device.window_s` in the result line) reads higher in a host-paced
cell."""


def read(ctx):
    s = ctx["summary"]
    return None if s is None else 1.0 - s.busy_s / ctx["plain_s"]
