"""Keypoint NMS + threshold + top-K detection.

Counterpart of gl_slam_tpu/ops/nms.py. `nms_plain` is the plain PyTorch
version of the suppression (the JAX `_nms_xla`: a (2r+1)^2 window max, then
`_suppress_with_tiebreak`); `nms_cuda` launches the hand-written kernel in
csrc/nms.cu, which replaces the Pallas window-max kernel `_nms_pallas` /
`_nms_kernel` and applies the tie-break in the same launch. `nms` takes the
plain version only for CPU tensors: a CUDA tensor launches the kernel or
raises.

Padding: the kernel and the plain version count pixels outside the image as
-inf; the Pallas kernel pads with 0.0. The three agree on the non-negative
heatmaps the detector produces (a softmax times masks), and the kernel
equals the plain version bit for bit on any f32 map without NaN (max is
exact). The kernel takes a contiguous float32 (B, H, W) map with B <= 65535
and radius <= 16. The plain version passes linear pixel indices through
float32 and so needs H * W < 2**24; the kernel compares positions, not
indices, and has no such limit.

The kernel streams rows through registers: a warp owns a strip of 128
columns and a segment of rows (`nms_plan` gives the grid it launches for a
map; csrc/nms.cu explains the design).

Both top-k stages must break ties toward the lower index like `lax.top_k`:
a suppressed map is mostly exact zeros (ops/select.topk_stable).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import tracing
from . import _build
from .select import topk_stable

_MAX_RADIUS = 16


def _window_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(B,H,W) float -> (2r+1)^2 neighbourhood max, out-of-image = -inf."""
    k = 2 * radius + 1
    return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]


def _suppress_with_tiebreak(heat: torch.Tensor, pooled: torch.Tensor,
                            radius: int) -> torch.Tensor:
    """Zero non-maxima given the window max; among equal-score pixels in a
    window only the smallest linear index survives."""
    B, H, W = heat.shape
    is_max = heat >= pooled
    lin = torch.arange(H * W, dtype=torch.float32,
                       device=heat.device).reshape(H, W)
    # Window max over -index in float32: exact, since H*W < 2**24.
    neg_idx = torch.where(is_max, -lin[None], float("-inf"))
    pooled_idx = _window_max(neg_idx, radius)
    survivor = is_max & (neg_idx == pooled_idx)
    return torch.where(survivor, heat, 0.0)


def nms_plain(heat: torch.Tensor, radius: int) -> torch.Tensor:
    """(B,H,W) -> scores suppressed to local maxima (the `_nms_xla` path)."""
    return _suppress_with_tiebreak(heat, _window_max(heat, radius), radius)


def _c_entry(name: str, n_ptr: int, n_int: int, tail_ptr: int = 1):
    fn = getattr(_build.load("nms"), name)
    fn.restype = _build.ctypes.c_int
    fn.argtypes = [_build.ctypes.c_void_p] * n_ptr \
        + [_build.ctypes.c_int] * n_int + [_build.ctypes.c_void_p] * tail_ptr
    return fn


def nms_plan(B: int, H: int, W: int, radius: int,
             seg_rows: int = 0) -> dict:
    """The grid the kernel launches for a (B, H, W) map: column strips, the
    columns each strip writes, rows per segment, segments and CTAs
    (`seg_rows` <= 0: the kernel's default)."""
    plan = (_build.ctypes.c_int * 5)()
    fn = _c_entry("gl_nms_plan", 0, 5)
    _build.check(fn(B, H, W, int(radius), int(seg_rows), plan), "nms plan")
    return dict(zip(("strips", "strip_cols", "seg_rows", "segments", "ctas"),
                    plan))


def nms_cuda(heat: torch.Tensor, radius: int,
             seg_rows: int = 0) -> torch.Tensor:
    """The CUDA kernel: window max and tie-break in one launch. `seg_rows`
    sets the rows per segment (<= 0: the kernel's default plan)."""
    if not heat.is_cuda:
        raise ValueError("nms_cuda: heat must be a CUDA tensor")
    if heat.dtype != torch.float32:
        raise ValueError(f"nms_cuda: heat must be float32, got {heat.dtype}")
    if heat.dim() != 3:
        raise ValueError(f"nms_cuda: heat must be (B, H, W), got "
                         f"{tuple(heat.shape)}")
    if not heat.is_contiguous():
        raise ValueError("nms_cuda: heat must be contiguous")
    if not 0 <= radius <= _MAX_RADIUS:
        raise ValueError(f"nms_cuda: radius {radius} not in "
                         f"[0, {_MAX_RADIUS}]")
    B, H, W = heat.shape
    if B > 65535:
        raise ValueError(f"nms_cuda: batch {B} > 65535")
    if heat.numel() >= 2 ** 31:
        raise ValueError("nms_cuda: the map holds 2^31 elements or more")
    out = torch.empty_like(heat)
    if heat.numel() == 0:
        return out
    fn = _c_entry("gl_nms_fwd_seg", 2, 5)
    err = fn(_build.ptr(heat), _build.ptr(out), B, H, W, int(radius),
             int(seg_rows), _build.stream_of(heat))
    _build.LAUNCHES["nms"] += 1
    _build.check(err, "nms")
    return out


def nms(heat: torch.Tensor, radius: int) -> torch.Tensor:
    """Dispatch on the device: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if heat.is_cuda:
        return nms_cuda(heat, radius)
    return nms_plain(heat, radius)


def detect_keypoints(heat: torch.Tensor, max_keypoints: int,
                     score_threshold: float, radius: int):
    """(B,H,W) heatmap -> fixed-K (kpts xy int32 (B,K,2), scores (B,K),
    valid (B,K)); per-row top-R then a global top-K when the map is much
    larger than K."""
    B, H, W = heat.shape
    with tracing.span("extract.nms"):
        supp = nms(heat, radius)
    per_row = min(max(W // (radius + 1) + 1, 8), W)
    if H * W > 4 * max_keypoints and per_row * H >= max_keypoints:
        s_row, x_row = topk_stable(supp, per_row)              # (B,H,R)
        rows = torch.arange(H, dtype=torch.int32, device=heat.device)
        cand_scores = s_row.reshape(B, H * per_row)
        cand_x = x_row.reshape(B, H * per_row).to(torch.int32)
        cand_y = rows[None, :, None].expand(B, H, per_row).reshape(
            B, H * per_row)
        scores, sel = topk_stable(cand_scores, max_keypoints)
        xs = torch.gather(cand_x, 1, sel)
        ys = torch.gather(cand_y, 1, sel)
    else:
        scores, idx = topk_stable(supp.reshape(B, H * W), max_keypoints)
        ys = (idx // W).to(torch.int32)
        xs = (idx % W).to(torch.int32)
    kpts = torch.stack([xs, ys], dim=-1)
    valid = scores > score_threshold
    return kpts, torch.where(valid, scores, 0.0), valid
