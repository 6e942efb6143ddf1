"""Device milliseconds a tracked frame in the tracking loop's stages
(slam/frontend.track_step_impl: re-observation, pose LM, triangulation,
keyframe insertion, ...): the summed device spans (first kernel start to
last kernel end of each range) of the program's `track.*` ranges over the
traced window's frames. The program records its `track` span without a
profiler range, so the kernels a step issues between its stages are not
in it. None where the trace has no such range."""


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    spans = [v for k, v in s.span_s.items() if k.startswith("track.")]
    return 1e3 * sum(spans) / ctx["frames"] if spans else None
