"""The assignment kernel's share of its roofline: the least time the
assignment that the cell's LightGlue passes need could take on the card
(benchmark/flops.assignment_work), over the device time of the kernels
named `assign_pass`."""

from benchmark import flops, trace


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    t, n = trace.device_time(s, ("assign_pass",))
    if n == 0:
        raise trace.TraceError("the matcher ran but the trace holds no "
                               "assign_pass")
    calls = flops.assignment_calls(ctx["shape"])
    need = ctx["frames"] * sum(flops.bound_s(f, b) for f, b in calls)
    return 100.0 * need / t
