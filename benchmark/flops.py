"""Operations and bytes of the work a cell needs, from its shapes.

Frozen copies of the port's measurement arithmetic (`frame_flops` and
the three counts it adds up; the roofline `bound` and the H100 peaks),
plus the counts of the two matcher kernels' work that the kernel
rooflines divide by.

`frame_flops` counts the matmul and convolution FLOPs of one tracked
frame: the SuperPoint CNN, the prologue's LightGlue pass with its
similarity, the pair head, and the re-observation passes. It does not
count the BA passes, the geometry's small solves, the element-wise work
or the loop detections, so `mfu` built on it is a lower bound on the
share of the peak that the card spends on useful work.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit.
PEAK_BF16_FLOPS = 989.4e12
PEAK_BYTES = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the memory bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


# ---------------------------------------------------------------------------
# FLOPs of one tracked frame

def _conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    return 2 * h * w * cin * cout * k * k


def superpoint_flops(height: int, width: int, channels, desc_dim: int,
                     stem_stride: int = 2) -> int:
    """One image through SuperPointNet, padded to a multiple of 8: the 3x3
    encoder at the stem's resolution, halved after blocks 1, 3 and 5 while
    pools remain, then both 3x3 heads to 256 and the 1x1 projections to 65
    cells and to the descriptor."""
    h = (height + (-height) % 8) // stem_stride
    w = (width + (-width) % 8) // stem_stride
    pools = {1: 3, 2: 2, 4: 1}[stem_stride]
    cin = [stem_stride * stem_stride] + list(channels[:-1])
    total = 0
    for i, (a, b) in enumerate(zip(cin, channels)):
        total += _conv(h, w, a, b, 3)
        if i in (1, 3, 5) and pools > 0:
            pools -= 1
            h, w = h // 2, w // 2
    c = channels[-1]
    return total + 2 * _conv(h, w, c, 256, 3) + _conv(h, w, 256, 65, 1) \
        + _conv(h, w, 256, desc_dim, 1)


def lightglue_flops(n: int, m: int, dim: int, heads: int, layers: int,
                    input_dim: int) -> int:
    """One LightGlue pass over sets of n and m points, with the
    assignment's similarity f0 f1^T: the input projection and the rotary
    frequencies; per layer the q/k/v/o projections of self- and
    cross-attention (8 d^2 a point), both MLPs (12 d^2 a point each), and
    QK^T and PV of every attention call (4 d (n + m)^2 in all); the final
    projection and the matchability."""
    p = n + m
    per_layer = 40 * p * dim * dim + 4 * dim * p * p
    return (2 * p * input_dim * dim + 2 * p * (dim // heads)
            + layers * per_layer + 2 * p * dim * dim + 2 * p * dim
            + 2 * n * m * dim)


def pair_head_flops(n: int, desc_dim: int, hidden: int, patch: int) -> int:
    """The pair sub-pixel head on n matched rows."""
    din = 2 * patch * patch + 2 * desc_dim + 1
    return 2 * n * (din * hidden + hidden * hidden + hidden * 2)


def reobs_passes(reobs_mode: str, use_covis_retrieval: bool) -> int:
    """LightGlue re-observation passes a frame: two in the "separate" mode
    (one without covisibility retrieval), one in "merged", the two sets of
    one batch-2 call in "batched"."""
    if reobs_mode == "merged":
        return 1
    if reobs_mode == "batched":
        return 2
    return 2 if use_covis_retrieval else 1


def frame_flops(shape: dict) -> int:
    """Matmul and convolution FLOPs (2 per multiply-add) of one tracked
    frame at a configuration's shapes (`shape`: see `cell_shape`)."""
    n, dd, m = shape["keypoints"], shape["desc_dim"], shape["reobs_points"]
    lg = shape["lightglue"]

    def lg_pass(a, b):
        return lightglue_flops(a, b, lg["dim"], lg["heads"], lg["layers"],
                               dd)

    total = superpoint_flops(shape["height"], shape["width"],
                             shape["sp_channels"], dd,
                             shape["stem_stride"]) + lg_pass(n, n)
    if shape["pair_head_hidden"] is not None:
        total += pair_head_flops(n, dd, shape["pair_head_hidden"],
                                 shape["pair_head_patch"])
    return total + shape["reobs_passes"] * lg_pass(m, n)


# ---------------------------------------------------------------------------
# The matcher kernels' work a frame

def _pairs(shape: dict):
    """(n, m) of every LightGlue pass a frame: the prologue's frame pair,
    then each re-observation pass's candidate set against the frame."""
    n, m = shape["keypoints"], shape["reobs_points"]
    return [(n, n)] + [(m, n)] * shape["reobs_passes"]


def attention_calls(shape: dict) -> list:
    """(flops, bytes) of every attention a frame's LightGlue passes need:
    per layer self-attention of each set and cross-attention both ways,
    QK^T and PV on every head (4 nq nk d FLOPs a call); q, k and v read
    once and the output written once, in bf16, and the key mask."""
    d = shape["lightglue"]["dim"]
    out = []
    for a, b in _pairs(shape):
        for nq, nk in ((a, a), (b, b), (a, b), (b, a)):
            out += [(4 * nq * nk * d, BF16 * d * (2 * nq + 2 * nk) + nk)] \
                * shape["lightglue"]["layers"]
    return out


def assignment_calls(shape: dict) -> list:
    """(flops, bytes) of the assignment of each of a frame's LightGlue
    passes: the similarity f0 f1^T once (2 n m d FLOPs); the bf16 features,
    the f32 matchability and the masks read once, and the three (n,) and
    three (m,) 4-byte outputs (index, max, logsumexp) written once."""
    d = shape["lightglue"]["dim"]
    return [(2 * a * b * d, (BF16 * d + 4 + 1 + 12) * (a + b))
            for a, b in _pairs(shape)]


def cell_shape(cfg_file: dict) -> dict:
    """The shapes that the counts above read, from a configuration file."""
    p, nets = cfg_file["pipeline"], cfg_file["networks"]
    head = nets.get("pair_head")
    return dict(
        height=p["image_height"], width=p["image_width"],
        keypoints=p["max_keypoints"], desc_dim=nets["descriptor_dim"],
        reobs_points=p["covis_max_points"],
        reobs_passes=reobs_passes(p["reobs_mode"], p["use_covis_retrieval"]),
        sp_channels=tuple(nets["superpoint_channels"]),
        stem_stride=nets["superpoint_stem_stride"],
        lightglue=dict(dim=nets["lightglue_dim"],
                       heads=nets["lightglue_heads"],
                       layers=nets["lightglue_layers"]),
        pair_head_hidden=None if head is None else head["hidden"],
        pair_head_patch=7 if head is None else head["patch"])
