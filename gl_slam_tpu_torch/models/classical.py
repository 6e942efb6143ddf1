"""Classical (training-free) corner detector + patch descriptors.

Counterpart of gl_slam_tpu/models/classical.py: a Harris corner response
(central differences, 3x3 box-blurred structure tensor), the detector's
NMS and top-K selection (`ops/nms.detect_keypoints`: on the card the
hand-written NMS kernel, on the CPU its plain version; the JAX package
takes its XLA window max here, the same function), and L2-normalised,
mean-subtracted blurred intensity patches as descriptors.

The blur sums the three taps in the order XLA's `jnp.convolve` does (left,
centre, right, each times 1/3), which gives the JAX response bit for bit,
so the keypoints are the JAX package's exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import nms as nms_ops
from .subpix import gather_patches


def _box_blur(img: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Separable box blur of (..., H, W), zero padded ('same' size)."""
    w = 1.0 / k
    r = k // 2
    p = F.pad(img, (r, k - 1 - r))
    W = img.shape[-1]
    img = sum(p[..., :, j:j + W] * w for j in range(k))
    p = F.pad(img, (0, 0, r, k - 1 - r))
    H = img.shape[-2]
    return sum(p[..., j:j + H, :] * w for j in range(k))


def harris_response(img: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris corner response of a (..., H, W) [0, 1] grayscale image."""
    dx = (F.pad(img, (0, 2))[..., :, 2:] - F.pad(img, (2, 0))[..., :, :-2]) \
        * 0.5
    dy = (F.pad(img, (0, 0, 0, 2))[..., 2:, :]
          - F.pad(img, (0, 0, 2, 0))[..., :-2, :]) * 0.5
    Ixx = _box_blur(dx * dx)
    Iyy = _box_blur(dy * dy)
    Ixy = _box_blur(dx * dy)
    det = Ixx * Iyy - Ixy * Ixy
    tr = Ixx + Iyy
    return det - k * tr * tr


def patch_descriptors(img: torch.Tensor, kpts: torch.Tensor,
                      patch: int = 8) -> torch.Tensor:
    """Mean-subtracted, L2-normalised blurred patches: img (..., H, W),
    kpts (..., N, 2) -> (..., N, patch * patch)."""
    p = gather_patches(_box_blur(img, 3), kpts, patch)
    d = p.reshape(*p.shape[:-2], -1)
    d = d - d.mean(dim=-1, keepdim=True)
    return d / torch.clamp_min(torch.linalg.vector_norm(d, dim=-1,
                                                        keepdim=True), 1e-8)


class HarrisExtractor:
    """Fixed-K classical extractor with the learned extractor's contract:
    images (B, H, W) in [0, 1] -> (kpts (B, K, 2) float32, scores (B, K),
    desc (B, K, patch^2), valid (B, K)). Runs on the images' device."""

    def __init__(self, height: int, width: int, max_keypoints: int = 2048,
                 patch: int = 8, nms_radius: int = 4,
                 score_threshold: float = 1e-6):
        self.height = height
        self.width = width
        self.max_keypoints = max_keypoints
        self.patch = patch
        self.nms_radius = nms_radius
        self.score_threshold = score_threshold

    @torch.no_grad()
    def __call__(self, images: torch.Tensor):
        H, W, b = self.height, self.width, self.patch
        resp = harris_response(images)
        # kill the borders (patch sampling and gradient validity)
        dev = images.device
        rows = torch.arange(H, device=dev)
        cols = torch.arange(W, device=dev)
        row_ok = ((rows >= b) & (rows < H - b)).to(resp.dtype)
        col_ok = ((cols >= b) & (cols < W - b)).to(resp.dtype)
        resp = (resp * row_ok[:, None] * col_ok[None, :]).contiguous()
        kpts, scores, valid = nms_ops.detect_keypoints(
            resp, self.max_keypoints, self.score_threshold, self.nms_radius)
        kpts = kpts.float()
        desc = patch_descriptors(images, kpts, b)
        return kpts, scores, desc, valid
