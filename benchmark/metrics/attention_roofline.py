"""The attention kernel's share of its roofline: the least time the
attention that the cell's LightGlue passes need could take on the card
(benchmark/flops.attention_work, from the configuration's shapes), over
the device time of the kernels named `attention_kernel`."""

from benchmark import flops, trace


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    t, n = trace.device_time(s, ("attention_kernel",))
    if n == 0:
        raise trace.TraceError("the matcher ran but the trace holds no "
                               "attention_kernel")
    calls = flops.attention_calls(ctx["shape"])
    need = ctx["frames"] * sum(flops.bound_s(f, b) for f, b in calls)
    return 100.0 * need / t
