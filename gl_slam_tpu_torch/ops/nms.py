"""Keypoint NMS + threshold + top-K detection, as plain PyTorch.

Counterpart of gl_slam_tpu/ops/nms.py on the path the chunked tracker runs:
the JAX `nms()` takes its XLA `reduce_window` version unless the caller asks
for the opt-in Pallas kernel, so this module ports `_nms_xla`,
`_suppress_with_tiebreak` and the two-stage `detect_keypoints`. (The Pallas
window-max kernel `_nms_pallas` is not ported yet; see ROADMAP.md.)

Both top-k stages must break ties toward the lower index like `lax.top_k`:
a suppressed map is mostly exact zeros (ops/select.topk_stable).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .select import topk_stable


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


def nms(heat: torch.Tensor, radius: int) -> torch.Tensor:
    """(B,H,W) -> scores suppressed to local maxima (the `_nms_xla` path)."""
    return _suppress_with_tiebreak(heat, _window_max(heat, radius), radius)


def detect_keypoints(heat: torch.Tensor, max_keypoints: int,
                     score_threshold: float, radius: int):
    """(B,H,W) heatmap -> fixed-K (kpts xy int32 (B,K,2), scores (B,K),
    valid (B,K)); per-row top-R then a global top-K when the map is much
    larger than K."""
    B, H, W = heat.shape
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
