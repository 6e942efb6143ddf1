"""Device milliseconds a tracked frame inside the `bench.chunk` ranges: their
summed device span (first kernel start to last kernel end of each range)
over the traced window's frames."""


def read(ctx):
    s = ctx["summary"]
    if s is None or "bench.chunk" not in s.span_s:
        return None
    return 1e3 * s.span_s["bench.chunk"] / ctx["frames"]
