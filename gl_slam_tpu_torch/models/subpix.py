"""Sub-pixel keypoint refinement: the centroid and the two learned heads.

Counterpart of gl_slam_tpu/models/subpix.py: `gather_patches`,
`centroid_refine` (and their naive forms), `SubpixHead`, `PairSubpixHead`,
`SubpixRefiner` and `pair_refine_scatter`.
The JAX package computes the centroid densely with shift-adds at large
images and gathers patches through an x-packed copy of the image (TPU
gather workarounds); this port gathers the (P, P) windows directly, which
gives identical patches and the centroid up to float32 summation order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device, upload
from . import init_like_flax
from .lightglue import Dense


def gather_patches(img: torch.Tensor, kpts: torch.Tensor,
                   patch: int) -> torch.Tensor:
    """(P, P) windows centred at the integer part of each keypoint, with
    out-of-bounds indices clamped. img (..., H, W); kpts (..., N, 2) xy ->
    (..., N, P, P).

    Above 16384 pixels the JAX package gathers from an x-packed copy of the
    image, which clamps a keypoint's x into the image before taking its
    window; this does the same there, so a keypoint outside the image (a
    refined one can round to x = -1) reads the same patch as in the JAX
    package at every size."""
    H, W = img.shape[-2:]
    r = patch // 2
    off = torch.arange(patch, device=img.device) - r
    x = kpts[..., 0:1].to(torch.int32)
    if H * W > 16384:
        x = torch.clamp(x, 0, W - 1)
    xs = torch.clamp(x + off, 0, W - 1)
    ys = torch.clamp(kpts[..., 1:2].to(torch.int32) + off, 0, H - 1)
    idx = (ys[..., :, None] * W + xs[..., None, :]).long()   # (..., N, P, P)
    flat = img.reshape(*img.shape[:-2], H * W)
    lead = idx.shape[:-3]
    out = torch.gather(flat, -1, idx.reshape(*lead, -1))
    return out.reshape(idx.shape)


def gather_patches_naive(img: torch.Tensor, kpts: torch.Tensor,
                         patch: int) -> torch.Tensor:
    """The direct element gather of the JAX package's tests: img (H, W),
    kpts (N, 2) -> (N, P, P), each index clamped into the image on its
    own (`gather_patches` at 16384 pixels or fewer)."""
    H, W = img.shape
    r = patch // 2
    off = torch.arange(patch, device=img.device) - r
    xs = torch.clamp(kpts[:, 0:1].to(torch.int32) + off, 0, W - 1)
    ys = torch.clamp(kpts[:, 1:2].to(torch.int32) + off, 0, H - 1)
    return img[ys[:, :, None].long(), xs[:, None, :].long()]


def centroid_refine_naive(heat: torch.Tensor, kpts: torch.Tensor,
                          patch: int = 5) -> torch.Tensor:
    """`centroid_refine` of one (H, W) map through the naive gather."""
    r = patch // 2
    patches = gather_patches_naive(heat, kpts, patch)
    off = torch.arange(patch, dtype=torch.float32, device=heat.device) - r
    w = torch.clamp_min(patches, 0.0)
    tot = torch.clamp_min(w.sum(dim=(1, 2)), 1e-9)
    dx = (w * off[None, None, :]).sum(dim=(1, 2)) / tot
    dy = (w * off[None, :, None]).sum(dim=(1, 2)) / tot
    return kpts + torch.stack([dx, dy], dim=-1)


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


def _offsets(head, x: torch.Tensor) -> torch.Tensor:
    """The heads' MLP: two dense layers with tanh-approximated GELU in the
    head's dtype (products and bias adds round to it), a last dense layer
    in float32, then `offset_range * tanh`."""
    x = F.gelu(head.dense0(x.to(head.dtype)), approximate="tanh")
    x = F.gelu(head.dense1(x), approximate="tanh")
    return head.offset_range * torch.tanh(head.dense2(x.float()))


class SubpixHead(nn.Module):
    """Single-view sub-pixel refinement: per keypoint, the (P, P) image
    patch around the integer detection and the descriptor sampled there ->
    a bounded offset (px) in (-offset_range, offset_range)^2.

    Three dense layers, P^2 + D -> hidden -> hidden -> 2; the two hidden
    layers run in `dtype` (bfloat16 by default, as the Flax module), the
    last in float32. Flax's `nn.gelu` is the tanh approximation."""

    def __init__(self, desc_dim: int, hidden: int = 128, patch: int = 5,
                 offset_range: float = 1.5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.patch = patch
        self.offset_range = offset_range
        self.dtype = dtype
        self.dense0 = Dense(patch * patch + desc_dim, hidden, dtype=dtype)
        self.dense1 = Dense(hidden, hidden, dtype=dtype)
        self.dense2 = Dense(hidden, 2, dtype=torch.float32)

    def forward(self, patches, desc):
        """patches (..., N, P, P); desc (..., N, D) -> (..., N, 2) float32
        offsets."""
        lead = patches.shape[:-2]
        return _offsets(self, torch.cat([patches.reshape(*lead, -1), desc],
                                        dim=-1))


class PairSubpixHead(nn.Module):
    """Pair-conditioned sub-pixel refinement (Keypt2Subpx): per match, the
    (P, P) image patches around both integer keypoints, both descriptors
    and the match score -> a bounded offset (px) for the CURRENT keypoint.

    The layers of `SubpixHead`, with an input of 2 P^2 + 2 D + 1."""

    def __init__(self, desc_dim: int, hidden: int = 128, patch: int = 7,
                 offset_range: float = 1.5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.patch = patch
        self.offset_range = offset_range
        self.dtype = dtype
        self.dense0 = Dense(2 * patch * patch + 2 * desc_dim + 1, hidden,
                            dtype=dtype)
        self.dense1 = Dense(hidden, hidden, dtype=dtype)
        self.dense2 = Dense(hidden, 2, dtype=torch.float32)

    def forward(self, patches0, patches1, desc0, desc1, mscore):
        """patches0/1 (..., M, P, P) prev/cur image patches at the matched
        integer keypoints; desc0/1 (..., M, D); mscore (..., M) in [0, 1]
        -> (..., M, 2) float32 offsets for the current keypoints."""
        lead = patches1.shape[:-2]
        return _offsets(self, torch.cat(
            [patches0.reshape(*lead, -1), patches1.reshape(*lead, -1),
             desc0, desc1, mscore[..., None]], dim=-1))


class SubpixRefiner:
    """The single-view head with the reference refiner's surface: a score
    heatmap, keypoints and their descriptors -> refined keypoints.

    `head`: a SubpixHead (for example e2e.load_flagship_subpix(pair=False));
    None builds one of `desc_dim` initialised as Flax initialises it, from
    `seed`. `device`: the card by default (raises without CUDA), or
    "cpu"."""

    def __init__(self, patch: int = 5, desc_dim: int = 256, seed: int = 0,
                 head: "SubpixHead | None" = None, device=None):
        self.device = resolve_device(device)
        if head is None:
            head = init_like_flax(SubpixHead(desc_dim, patch=patch),
                                  torch.Generator().manual_seed(seed))
        self.patch = head.patch
        self.head = head.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, heat, kpts, desc) -> torch.Tensor:
        """heat (H, W) detector heatmap; kpts (N, 2); desc (N, D) ->
        refined (N, 2) float32 keypoints."""
        heat, kpts, desc = (upload(x, torch.float32, self.device)
                            for x in (heat, kpts, desc))
        patches = gather_patches(heat, kpts, self.patch)
        return kpts + self.head(patches, desc)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, *tail), idx (..., M) long -> x[..., idx, *tail]."""
    tail = x.shape[idx.dim():]
    flat = x.reshape(*x.shape[:idx.dim()], -1)
    n = flat.shape[-1]
    out = torch.gather(flat, idx.dim() - 1, idx[..., None].expand(
        *idx.shape, n))
    return out.reshape(*idx.shape, *tail)


def pair_refine_scatter(head: PairSubpixHead, img_patches0, img_patches1,
                        desc0, desc1, kpts1, matches0, mscores0, pair_mask):
    """Refine the current frame's matched keypoints with the pair head.

    matches0 (..., N): prev row -> cur row (-1 = none); pair_mask (..., N):
    rows that passed the score filter. For each masked prev row i with
    partner j = matches0[i], the head sees (patch_i, patch_j, desc_i,
    desc_j, score_i) and round(kpts1[j]) + its offset replaces kpts1[j];
    every other current keypoint keeps its coordinates bit for bit. The
    matcher is mutual, so no two rows write the same j. Offsets are
    relative to round(kpts1) (half to even, as jnp.round), the pixel the
    patch is centred on."""
    N = matches0.shape[-1]
    j = matches0.long().clamp(0, N - 1)
    off = head(img_patches0, _take_rows(img_patches1, j), desc0,
               _take_rows(desc1, j), mscores0)
    refined = _take_rows(torch.round(kpts1), j) + off
    # rows that do not write go to a dummy row N, dropped afterwards
    rows = torch.where(pair_mask & (matches0 >= 0), j, N)
    out = torch.cat([kpts1, kpts1.new_zeros(*kpts1.shape[:-2], 1, 2)], -2)
    out = out.scatter(-2, rows[..., None].expand(*rows.shape, 2),
                      refined.to(out.dtype))
    return out[..., :N, :]
