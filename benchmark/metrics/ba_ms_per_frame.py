"""Device milliseconds a tracked frame inside the `bench.ba` ranges: their
summed device span (first kernel start to last kernel end of each range)
over the traced window's frames."""


def read(ctx):
    s = ctx["summary"]
    if s is None or "bench.ba" not in s.span_s:
        return None
    return 1e3 * s.span_s["bench.ba"] / ctx["frames"]
