"""LightGlue-style attention matcher — fixed-N, masked.

Counterpart of gl_slam_tpu/models/lightglue.py: L transformer layers of
masked self-attention (2D rotary encoding of the keypoints) and
bidirectional cross-attention, then either the dense dual-softmax
assignment (`assignment`) or the final projections for the fused
assignment kernel (`return_features=True`, ops/assignment.py).

Every function takes leading batch dimensions where the JAX version is
vmapped: descriptors (..., N, D), keypoints (..., N, 2), masks (..., N).
Parameters are stored in float32 and cast to the module's compute dtype at
each call, as Flax does; `rope.freqs` and `matchability` run in float32
whatever the compute dtype. Flax's `nn.gelu` is the tanh approximation.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device, upload
from ..ops import attention as attn_ops
from . import init_like_flax

_NEG = -1e9


class MatchOutput(NamedTuple):
    matches0: torch.Tensor   # (..., N) int32 into set 1, -1 = none
    mscores0: torch.Tensor   # (..., N) float32
    matches1: torch.Tensor   # (..., M) int32 into set 0
    mscores1: torch.Tensor   # (..., M)
    scores: Optional[torch.Tensor]  # (..., N, M) assignment probabilities


class Dense(nn.Linear):
    """`flax.linen.Dense` with `dtype`: inputs, kernel and bias are cast to
    the compute dtype; the product and the bias add each round to it."""

    def __init__(self, din: int, dout: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(din, dout, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class _GELU(nn.Module):
    def forward(self, x):
        return F.gelu(x, approximate="tanh")


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


class RotaryEncoding(nn.Module):
    """Learnable 2D rotary positional encoding on normalized keypoints."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.freqs = Dense(2, head_dim // 2, bias=False, dtype=torch.float32)

    def forward(self, kpts):                 # (..., N, 2) in [-1, 1]
        f = self.freqs(kpts.float())
        emb = torch.cat([f, f], dim=-1)
        return torch.cos(emb), torch.sin(emb)  # each (..., N, hd)


def _apply_rotary(x, cos, sin):
    # x: (..., H, N, hd); cos/sin: (..., N, hd)
    return x * cos[..., None, :, :] + _rotate_half(x) * sin[..., None, :, :]


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.q = Dense(dim, dim, dtype=dtype)
        self.k = Dense(dim, dim, dtype=dtype)
        self.v = Dense(dim, dim, dtype=dtype)
        self.o = Dense(dim, dim, dtype=dtype)

    def _heads(self, x):                     # (..., N, dim) -> (..., H, N, hd)
        hd = self.dim // self.heads
        return x.unflatten(-1, (self.heads, hd)).transpose(-3, -2)

    def forward(self, x, source, mask_q, mask_k, rot_q=None, rot_k=None):
        """x (..., N, dim) attends to source (..., M, dim)."""
        hd = self.dim // self.heads
        q = self._heads(self.q(x))
        k = self._heads(self.k(source))
        v = self._heads(self.v(source))
        if rot_q is not None:
            q = _apply_rotary(q, *rot_q)
            k = _apply_rotary(k, *rot_k)
        out = attn_ops.attention(q.to(self.dtype).contiguous(),
                                 k.to(self.dtype).contiguous(),
                                 v.contiguous(), mask_k.contiguous(),
                                 1.0 / float(hd) ** 0.5)
        out = out.transpose(-3, -2).flatten(-2)
        out = self.o(out)
        return torch.where(mask_q[..., None], out, 0.0)


def _mlp(dim: int, dtype) -> nn.Sequential:
    return nn.Sequential(Dense(2 * dim, 2 * dim, dtype=dtype), _GELU(),
                         Dense(2 * dim, dim, dtype=dtype))


class GlueLayer(nn.Module):
    """One matcher layer over both sets; self- and cross-attention weights
    are shared between the sets.

    Sets of EQUAL size run each attention as one batched call over a
    stacked set axis (the JAX `nn.vmap` path); unequal sets (a small
    re-observation set against the full frame) run per-set calls at their
    true sizes."""

    def __init__(self, dim: int, heads: int, dtype=torch.bfloat16):
        super().__init__()
        self.self_attn = Attention(dim, heads, dtype)
        self.cross_attn = Attention(dim, heads, dtype)
        self.mlp_s = _mlp(dim, dtype)
        self.mlp_c = _mlp(dim, dtype)

    def forward(self, d0, d1, rot0, rot1, m0, m1):
        sa, ca = self.self_attn, self.cross_attn
        if d0.shape == d1.shape:
            d = torch.stack([d0, d1], dim=-3)            # (..., 2, N, dim)
            rot = (torch.stack([rot0[0], rot1[0]], dim=-3),
                   torch.stack([rot0[1], rot1[1]], dim=-3))
            m = torch.stack([m0, m1], dim=-2)
            d = d + self.mlp_s(torch.cat([d, sa(d, d, m, m, rot, rot)], -1))
            c = ca(d, d.flip(-3), m, m.flip(-2))
            d = d + self.mlp_c(torch.cat([d, c], -1))
            return d[..., 0, :, :], d[..., 1, :, :]
        d0 = d0 + self.mlp_s(torch.cat([d0, sa(d0, d0, m0, m0, rot0, rot0)],
                                       -1))
        d1 = d1 + self.mlp_s(torch.cat([d1, sa(d1, d1, m1, m1, rot1, rot1)],
                                       -1))
        c0 = ca(d0, d1, m0, m1)
        c1 = ca(d1, d0, m1, m0)
        d0 = d0 + self.mlp_c(torch.cat([d0, c0], -1))
        d1 = d1 + self.mlp_c(torch.cat([d1, c1], -1))
        return d0, d1


class LightGlueNet(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 4, layers: int = 9,
                 input_dim: int = 256, dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.inp = Dense(input_dim, dim, dtype=dtype)
        self.rope = RotaryEncoding(dim // heads)
        self.layers = nn.ModuleList(GlueLayer(dim, heads, dtype)
                                    for _ in range(layers))
        self.final = Dense(dim, dim, dtype=dtype)
        self.matchability = Dense(dim, 1, dtype=torch.float32)

    def forward(self, desc0, desc1, kpts0, kpts1, m0, m1,
                return_features: bool = False):
        """desc (..., N, Din); kpts normalized to [-1, 1]; m validity masks.
        Returns (sim (..., N, M), z0, z1), or with `return_features` the
        final projections (f0, f1, z0, z1) with sim = f0 @ f1^T / sqrt(dim).
        """
        d0 = self.inp(desc0.to(self.dtype))
        d1 = self.inp(desc1.to(self.dtype))
        rot0 = self.rope(kpts0)
        rot1 = self.rope(kpts1)
        for layer in self.layers:
            d0, d1 = layer(d0, d1, rot0, rot1, m0, m1)
        f0 = self.final(d0)
        f1 = self.final(d1)
        z0 = self.matchability(d0.float())[..., 0]
        z1 = self.matchability(d1.float())[..., 0]
        if return_features:
            return f0, f1, z0, z1
        sim = torch.matmul(f0.float(), f1.float().transpose(-1, -2))
        return sim / math.sqrt(float(self.dim)), z0, z1


def assignment(sim, z0, z1, m0, m1, threshold: float) -> MatchOutput:
    """Dual-softmax + matchability -> mutual matches (fixed shapes), with
    -1 sentinels for unmatched rows/columns."""
    sim = torch.where(m0[..., :, None] & m1[..., None, :], sim, _NEG)
    p0 = torch.log_softmax(sim, dim=-1)
    p1 = torch.log_softmax(sim, dim=-2)
    cert0 = F.logsigmoid(z0)[..., :, None]
    cert1 = F.logsigmoid(z1)[..., None, :]
    scores = torch.exp(p0 + p1 + cert0 + cert1)
    s0, nn0 = scores.amax(dim=-1), scores.argmax(dim=-1)   # first max
    s1, nn1 = scores.amax(dim=-2), scores.argmax(dim=-2)
    N, M = scores.shape[-2], scores.shape[-1]
    ar0 = torch.arange(N, device=sim.device)
    ar1 = torch.arange(M, device=sim.device)
    ok0 = (torch.gather(nn1, -1, nn0) == ar0) & m0 & (s0 > threshold)
    ok1 = (torch.gather(nn0, -1, nn1) == ar1) & m1 & (s1 > threshold)
    return MatchOutput(
        matches0=torch.where(ok0, nn0, -1).to(torch.int32),
        mscores0=torch.where(ok0, s0, 0.0),
        matches1=torch.where(ok1, nn1, -1).to(torch.int32),
        mscores1=torch.where(ok1, s1, 0.0),
        scores=scores)


def normalize_keypoints(kpts: torch.Tensor, height: int,
                        width: int) -> torch.Tensor:
    """Pixel -> [-1, 1]: shift by half-size, scale by half the larger side.
    The shift enters as Python scalars: a shift tensor built on the host
    would be a pageable copy to the card, which waits for the stream."""
    scale = max(width, height) / 2.0
    return torch.stack([(kpts[..., 0] - width / 2.0) / scale,
                        (kpts[..., 1] - height / 2.0) / scale], dim=-1)


class LightGlueMatcher:
    """Batched matcher: keypoints and descriptors of pairs of sets ->
    mutual matches above `threshold`, with -1 sentinels. The network's
    final projections go straight into the fused assignment (on the card
    the hand-written kernel, with attention's kernel in every layer), so
    no (N, M) score matrix is formed and `scores` is None.

    `net`: a LightGlueNet (for example the committed weights of
    e2e.load_flagship_frontend()[1]); None builds one of the given shape
    initialised as Flax initialises it, from `seed`. `device`: the card by
    default (raises without CUDA), or "cpu"."""

    def __init__(self, height: int, width: int, input_dim: int = 256,
                 dim: int = 256, heads: int = 4, layers: int = 9,
                 threshold: float = 0.1, seed: int = 0,
                 net: Optional[LightGlueNet] = None, device=None):
        self.height, self.width = height, width
        self.threshold = threshold
        self.device = resolve_device(device)
        if net is None:
            net = init_like_flax(LightGlueNet(dim=dim, heads=heads,
                                              layers=layers,
                                              input_dim=input_dim),
                                 torch.Generator().manual_seed(seed))
        self.net = net.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, kpts0, desc0, valid0, kpts1, desc1,
                 valid1) -> MatchOutput:
        """All arguments batched (B, N, ...) in pixels -> MatchOutput of
        (B, N) / (B, M) matches and scores."""
        # ops.assignment imports MatchOutput from this module
        from ..ops.assignment import fused_assignment
        dev = self.device
        k0, d0, k1, d1 = (upload(x, torch.float32, dev)
                          for x in (kpts0, desc0, kpts1, desc1))
        m0, m1 = (upload(x, torch.bool, dev) for x in (valid0, valid1))
        f0, f1, z0, z1 = self.net(
            d0, d1, normalize_keypoints(k0, self.height, self.width),
            normalize_keypoints(k1, self.height, self.width), m0, m1,
            return_features=True)
        return fused_assignment(f0, f1, z0, z1, m0, m1,
                                1.0 / float(self.net.dim) ** 0.5,
                                self.threshold)
