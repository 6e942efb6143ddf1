"""Kernel-launch calls a tracked frame: the host's `cudaLaunchKernel`
family of calls in the traced window over its frames (the dispatch layer:
parallel/multistream driving slam/fused)."""


def read(ctx):
    s = ctx["summary"]
    return None if s is None else s.launches / ctx["frames"]
