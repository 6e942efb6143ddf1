"""The front end and the pair refinement, written from their definitions.

For two consecutive images of a stream: detection (the SuperPoint
heatmap, padded to multiples of 8 with the padding zeroed; non-maximum
suppression over (2r+1)^2 windows, ties to the smaller linear index; the
`max_keypoints` best maxima, ties to the smaller index; valid above the
score threshold), the intensity-weighted centroid of each detection's
image patch, descriptors sampled bilinearly from the grid and
L2-normalised; then the matcher over the pair and, for the matches whose
score passes the match threshold, the pair head's offset from the rounded
current keypoint. Plain PyTorch; nothing of the program is imported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import nets


class Features(NamedTuple):
    kpts: torch.Tensor      # (B, N, 2) centroid-refined
    desc: torch.Tensor      # (B, N, D)
    valid: torch.Tensor     # (B, N)
    patches: torch.Tensor   # (B, N, P, P) around round(kpts)


def window_max(x: torch.Tensor, r: int) -> torch.Tensor:
    return F.max_pool2d(x[:, None], 2 * r + 1, stride=1, padding=r)[:, 0]


def suppress(heat: torch.Tensor, r: int) -> torch.Tensor:
    """Scores of the window maxima, zero elsewhere; of equal maxima within
    a window only the smallest linear index stays."""
    B, H, W = heat.shape
    is_max = heat >= window_max(heat, r)
    lin = torch.arange(H * W, device=heat.device, dtype=torch.float32)
    neg = torch.where(is_max, -lin.view(1, H, W), float("-inf"))
    keep = is_max & (neg == window_max(neg, r))
    return torch.where(keep, heat, 0.0)


def patches_at(img: torch.Tensor, kpts: torch.Tensor, P: int):
    """(P, P) windows of img (B, H, W) centred at the integer part of each
    keypoint (B, N, 2), indices clamped into the image (x first clamped on
    its own above 16384 pixels)."""
    B, H, W = img.shape
    r = P // 2
    off = torch.arange(P, device=img.device) - r
    x = kpts[..., 0].long()
    if H * W > 16384:
        x = x.clamp(0, W - 1)
    y = kpts[..., 1].long()
    xs = (x[..., None] + off).clamp(0, W - 1)          # (B, N, P)
    ys = (y[..., None] + off).clamp(0, H - 1)
    b = torch.arange(B, device=img.device)[:, None, None, None]
    return img[b, ys[..., :, None], xs[..., None, :]]


def centroid(img, kpts, P: int):
    w = patches_at(img, kpts, P).clamp_min(0.0)
    off = torch.arange(P, device=img.device, dtype=torch.float32) - P // 2
    tot = w.sum((-2, -1)).clamp_min(1e-9)
    dx = (w * off).sum((-2, -1)) / tot
    dy = (w * off[:, None]).sum((-2, -1)) / tot
    return kpts + torch.stack([dx, dy], -1)


def sample(grid: torch.Tensor, kpts: torch.Tensor, cell: int = 8):
    """Bilinear sample of grid (B, Hc, Wc, D) at pixel keypoints, cell
    centres at 8 c + 4, L2-normalised."""
    B, Hc, Wc, D = grid.shape
    x = kpts[..., 0] / cell - 0.5
    y = kpts[..., 1] / cell - 0.5
    x0 = x.floor().clamp(0, Wc - 2)
    y0 = y.floor().clamp(0, Hc - 2)
    fx = (x - x0).clamp(0.0, 1.0)[..., None]
    fy = (y - y0).clamp(0.0, 1.0)[..., None]
    x0, y0 = x0.long(), y0.long()
    b = torch.arange(B, device=grid.device)[:, None]
    d = (grid[b, y0, x0] * (1 - fx) * (1 - fy) + grid[b, y0, x0 + 1] * fx
         * (1 - fy) + grid[b, y0 + 1, x0] * (1 - fx) * fy
         + grid[b, y0 + 1, x0 + 1] * fx * fy)
    return d / torch.sqrt((d * d).sum(-1, keepdim=True) + 1e-12)


def extract(w_sp: dict, images: torch.Tensor, spec: dict, ops: nets.Ops,
            patch: int) -> Features:
    """images (B, H, W) -> Features at `spec`'s budget (max_keypoints,
    score_threshold, nms_radius, subpix_patch)."""
    B, H, W = images.shape
    x = F.pad(images, (0, (-W) % 8, 0, (-H) % 8))
    heat, grid = nets.superpoint(w_sp, x, ops, spec["stem_stride"])
    heat = heat.clone()
    heat[:, H:] = 0.0
    heat[:, :, W:] = 0.0
    supp = suppress(heat, spec["nms_radius"]).flatten(1)
    scores, idx = torch.sort(supp, dim=1, descending=True, stable=True)
    K = spec["max_keypoints"]
    scores, idx = scores[:, :K], idx[:, :K]
    Wp = heat.shape[-1]
    kpts = torch.stack([idx % Wp, idx // Wp], -1).float()
    valid = scores > spec["score_threshold"]
    kpts = centroid(images, kpts, spec["subpix_patch"])
    desc = sample(grid, kpts)
    return Features(kpts, desc, valid,
                    patches_at(images, torch.round(kpts), patch))


def normalize(kpts, H: int, W: int):
    s = max(W, H) / 2.0
    return torch.stack([(kpts[..., 0] - W / 2.0) / s,
                        (kpts[..., 1] - H / 2.0) / s], -1)


def refine_pair(w_lg: dict, w_head: dict, a: Features, b: Features, i: int,
                spec: dict, ops: nets.Ops):
    """Row i of frame pair (a, b): the matcher over the pair, then the pair
    head on the matches above the match threshold -> (kpts of b with the
    matched ones refined (N, 2), refined mask (N,))."""
    H, W = spec["image_height"], spec["image_width"]
    f0, f1, z0, z1 = nets.lightglue(
        w_lg, a.desc[i], b.desc[i], normalize(a.kpts[i], H, W),
        normalize(b.kpts[i], H, W), a.valid[i], b.valid[i],
        spec["lightglue_heads"], ops)
    m0, s0 = nets.assignment(f0, f1, z0, z1, a.valid[i], b.valid[i])
    keep = (m0 >= 0) & (s0 > spec["match_threshold"])
    N = m0.shape[0]
    j = m0.clamp(0, N - 1)
    off = nets.pair_head(w_head, a.patches[i], b.patches[i][j], a.desc[i],
                         b.desc[i][j], s0, ops, spec["offset_range"])
    out = b.kpts[i].clone()
    rows = j[keep]
    out[rows] = torch.round(b.kpts[i][rows]) + off[keep]
    refined = torch.zeros(N, dtype=torch.bool, device=out.device)
    refined[rows] = True
    return out, refined
