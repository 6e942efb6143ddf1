"""Idle milliseconds of the card a tracked frame while the host was in a
stage of the tracking loop: the traced window's idle gaps named by the
program's `track.*` ranges (the innermost host range at the gap's
midpoint), over the window's frames. The loop's gaps between its stages
take the name of the range around the call. None where the trace has no
`track.*` range."""


def read(ctx):
    s = ctx["summary"]
    if s is None or not any(k.startswith("track.") for k in s.span_s):
        return None
    idle = sum(v for k, v in s.gaps_s.items() if k.startswith("track."))
    return 1e3 * idle / ctx["frames"]
