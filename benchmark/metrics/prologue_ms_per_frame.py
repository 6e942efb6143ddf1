"""Device milliseconds a tracked frame in the prologue (slam/fused
chunk_fn: the S x T pair matching, pair head and essential RANSAC): the
summed device spans (first kernel start to last kernel end of each range)
of the program's `prologue.*` ranges over the traced window's frames. The
program records its `prologue` span without a profiler range, so the
ranges inside it are the layer's. None where the trace has no such
range."""


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    spans = [v for k, v in s.span_s.items() if k.startswith("prologue.")]
    return 1e3 * sum(spans) / ctx["frames"] if spans else None
