"""SuperPoint-style keypoint detector + descriptor network.

Counterpart of gl_slam_tpu/models/superpoint.py (the stem-stride-2 network
the committed checkpoints use). The public layouts are the JAX package's:
images (B, H, W, 1) in [0, 1] in, heatmap (B, H, W) and descriptor grid
(B, H/8, W/8, D) out; inside, the convolutions run in NCHW.

  * Space-to-depth stem: the JAX channel order of the (s x s) cell is
    (sy, sx, c), carried into NCHW as channel sy * s + sx (c = 1).
  * Detector head: a 65-way softmax in float32 over 8x8 cell pixels plus a
    dustbin; channel dy * 8 + dx of cell (cy, cx) is pixel
    (8 cy + dy, 8 cx + dx).
  * Descriptors: float32, normalized by rsqrt(sum of squares + 1e-12).

Weights are stored in float32 and cast to the compute dtype per call, as
Flax does with `dtype`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Conv2d):
    """`flax.linen.Conv` with `dtype` (SAME padding, stride 1)."""

    def __init__(self, cin: int, cout: int, k: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, padding=k // 2)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, 1, self.padding)
        return y + self.bias.to(dt)[:, None, None]


class SuperPointNet(nn.Module):
    """Encoder + detector/descriptor heads (stem stride 1, 2 or 4; total
    stride 8)."""

    def __init__(self, descriptor_dim: int = 256,
                 channels: Tuple[int, ...] = (64, 64, 64, 64,
                                              128, 128, 128, 128),
                 dtype: torch.dtype = torch.bfloat16, stem_stride: int = 2):
        super().__init__()
        if stem_stride not in (1, 2, 4):
            raise ValueError(f"stem_stride {stem_stride} not in (1, 2, 4)")
        self.stem_stride = stem_stride
        self.n_pools = {1: 3, 2: 2, 4: 1}[stem_stride]
        cin = [stem_stride * stem_stride] + list(channels[:-1])
        convs = [Conv(a, b, 3, dtype) for a, b in zip(cin, channels)]
        convs += [Conv(channels[-1], 256, 3, dtype),     # detector head
                  Conv(channels[-1], 256, 3, dtype)]     # descriptor head
        self.blocks = nn.ModuleList(convs)
        self.det = Conv(256, 65, 1, dtype)
        self.desc = Conv(256, descriptor_dim, 1, dtype)

    def forward(self, img, return_logits: bool = False):
        """img (B, H, W, 1) in [0, 1] -> (heat (B, H, W), desc grid
        (B, H/8, W/8, D)); with `return_logits` also the raw 65-way cell
        logits (B, H/8, W/8, 65) in the compute dtype, for the training
        cross-entropy (train/frontend_train.py)."""
        B, H, W, _ = img.shape
        s = self.stem_stride
        x = img.permute(0, 3, 1, 2)
        if s > 1:
            x = x.reshape(B, H // s, s, W // s, s).permute(0, 2, 4, 1, 3)
            x = x.reshape(B, s * s, H // s, W // s)
        blk = self.blocks
        x = F.relu(blk[1](F.relu(blk[0](x))))
        if self.n_pools >= 1:
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(blk[3](F.relu(blk[2](x))))
        if self.n_pools >= 2:
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(blk[5](F.relu(blk[4](x))))
        if self.n_pools >= 3:
            x = F.max_pool2d(x, 2, 2)
        feat = F.relu(blk[7](F.relu(blk[6](x))))

        logits = self.det(F.relu(blk[8](feat)))             # (B, 65, Hc, Wc)
        prob = torch.softmax(logits.float(), dim=1)[:, :64]
        Hc, Wc = prob.shape[-2:]
        heat = prob.reshape(B, 8, 8, Hc, Wc).permute(0, 3, 1, 4, 2)
        heat = heat.reshape(B, Hc * 8, Wc * 8)

        desc = self.desc(F.relu(blk[9](feat))).float()
        desc = desc * torch.rsqrt((desc * desc).sum(1, keepdim=True) + 1e-12)
        if return_logits:
            return heat, desc.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1)
        return heat, desc.permute(0, 2, 3, 1)


def sample_descriptors(desc_grid: torch.Tensor, kpts: torch.Tensor,
                       cell: int = 8) -> torch.Tensor:
    """Bilinearly sample the coarse grid at pixel keypoints.

    desc_grid (..., Hc, Wc, D); kpts (..., N, 2) pixel xy -> (..., N, D)
    unit-norm."""
    Hc, Wc, D = desc_grid.shape[-3:]
    flat = desc_grid.reshape(*desc_grid.shape[:-3], Hc * Wc, D)
    x = kpts[..., 0] / cell - 0.5
    y = kpts[..., 1] / cell - 0.5
    x0 = torch.clamp(torch.floor(x), 0, Wc - 2).to(torch.int32)
    y0 = torch.clamp(torch.floor(y), 0, Hc - 2).to(torch.int32)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]

    def at(yy, xx):
        idx = (yy * Wc + xx).long()[..., None].expand(*x0.shape, D)
        return torch.gather(flat, -2, idx)

    d00, d01 = at(y0, x0), at(y0, x0 + 1)
    d10, d11 = at(y0 + 1, x0), at(y0 + 1, x0 + 1)
    d = (d00 * (1 - fx) * (1 - fy) + d01 * fx * (1 - fy)
         + d10 * (1 - fx) * fy + d11 * fx * fy)
    return d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-12)
