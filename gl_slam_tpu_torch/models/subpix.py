"""Training-free sub-pixel keypoint refinement (the centroid path).

Counterpart of `gather_patches` / `centroid_refine` in
gl_slam_tpu/models/subpix.py. The JAX package computes the same centroid
densely with shift-adds at large images (a TPU gather workaround); this
port gathers the (P, P) windows directly, which gives identical results up
to float32 summation order. The learned heads (`SubpixHead`,
`PairSubpixHead`) are not ported yet.
"""

from __future__ import annotations

import torch


def gather_patches(img: torch.Tensor, kpts: torch.Tensor,
                   patch: int) -> torch.Tensor:
    """(P, P) windows centred at the integer part of each keypoint, with
    out-of-bounds indices clamped. img (..., H, W); kpts (..., N, 2) xy ->
    (..., N, P, P)."""
    H, W = img.shape[-2:]
    r = patch // 2
    off = torch.arange(patch, device=img.device) - r
    xs = torch.clamp(kpts[..., 0:1].to(torch.int32) + off, 0, W - 1)
    ys = torch.clamp(kpts[..., 1:2].to(torch.int32) + off, 0, H - 1)
    idx = (ys[..., :, None] * W + xs[..., None, :]).long()   # (..., N, P, P)
    flat = img.reshape(*img.shape[:-2], H * W)
    lead = idx.shape[:-3]
    out = torch.gather(flat, -1, idx.reshape(*lead, -1))
    return out.reshape(idx.shape)


def centroid_refine(heat: torch.Tensor, kpts: torch.Tensor,
                    patch: int = 5) -> torch.Tensor:
    """Score-weighted centroid of the local window (negative values
    clipped): kpts + (dx, dy)."""
    r = patch // 2
    patches = gather_patches(heat, kpts, patch)
    off = torch.arange(patch, dtype=torch.float32, device=heat.device) - r
    w = torch.clamp_min(patches, 0.0)
    tot = torch.clamp_min(w.sum(dim=(-2, -1)), 1e-9)
    dx = (w * off).sum(dim=(-2, -1)) / tot
    dy = (w * off[:, None]).sum(dim=(-2, -1)) / tot
    return kpts + torch.stack([dx, dy], dim=-1)
