"""The whole step's share of the card's dense bf16 peak: frame_flops
(matmul and convolution FLOPs of a tracked frame; no BA, geometry or
element-wise work) times the frames of the traced run's untraced steps,
over their wall time and 989.4 TFLOP/s. Those steps run just before the
profiled ones, with the same number of frames, so the profiler's slower
host does not enter the rate."""

from benchmark import flops


def read(ctx):
    if ctx["device"] != "cuda":
        return None
    f = flops.frame_flops(ctx["shape"]) * ctx["frames"]
    return 100.0 * f / ctx["plain_s"] / flops.PEAK_BF16_FLOPS
