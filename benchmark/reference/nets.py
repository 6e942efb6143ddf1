"""The networks, written from their equations in plain PyTorch.

SuperPoint (DeTone et al., CVPRW 2018) with a space-to-depth stride-2
stem, LightGlue (Lindenberger et al., ICCV 2023) without its adaptive
depth and width, and the pair sub-pixel head (Keypt2Subpx-style), each a
function of a weight dictionary read straight from the committed `.npz`
files (Flax parameter trees keyed "['params']['a']['b']").

Every product runs in float32 with TF32 off. `fp8=True` rounds both
operands of every convolution, dense layer and attention product to
float8 e4m3 (one scale a tensor: its largest magnitude maps to 448) and
accumulates in float32, as an fp8 matmul does: the control that the
comparison in `compare.py` must fail.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e9
FP8_MAX = 448.0


def load_npz(path: str, device) -> dict:
    """{('a', 'b', ...): float32 tensor} of a Flax checkpoint, the leading
    'params' dropped."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            parts = tuple(re.findall(r"\['([^']*)'\]", key))
            if parts and parts[0] == "params":
                parts = parts[1:]
            out[parts] = torch.as_tensor(np.asarray(z[key], np.float32),
                                         device=device)
    return out


def q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Ops:
    """The products of the networks, in float32 or fp8-rounded."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def _r(self, x):
        return q8(x) if self.fp8 else x

    def conv(self, x, w_hwio, b):
        w = w_hwio.permute(3, 2, 0, 1)
        k = w.shape[-1]
        return F.conv2d(self._r(x), self._r(w), None, 1, k // 2) \
            + b[:, None, None]

    def dense(self, x, w_io, b=None):
        y = torch.matmul(self._r(x), self._r(w_io))
        return y if b is None else y + b

    def attention(self, q, k, v, mask_k):
        """q (..., Nq, hd), k/v (..., Nk, hd), mask_k (..., Nk): masked keys
        at -1e9, softmax over keys (a fully masked row gives the mean of v)."""
        hd = q.shape[-1]
        logits = torch.matmul(self._r(q), self._r(k).transpose(-1, -2)) \
            / hd ** 0.5
        logits = torch.where(mask_k[..., None, :], logits, NEG)
        p = torch.softmax(logits, dim=-1)
        return torch.matmul(self._r(p), self._r(v))


# ---------------------------------------------------------------------------
# SuperPoint

def superpoint(w: dict, img: torch.Tensor, ops: Ops, stem: int = 2):
    """img (B, H, W) in [0, 1], H and W multiples of 8 -> (heat (B, H, W),
    descriptor grid (B, H/8, W/8, D)).

    Space-to-depth stem of `stem` (channel sy * stem + sx), eight 3x3
    convolutions with ReLU, a 2x2 max-pool after the second and fourth
    (and sixth at stem 1), then the detector head (3x3 to 256, ReLU, 1x1
    to 65 cells, softmax, the dustbin dropped, channel dy * 8 + dx of cell
    (cy, cx) at pixel (8 cy + dy, 8 cx + dx)) and the descriptor head (3x3
    to 256, ReLU, 1x1 to D, L2-normalised)."""
    B, H, W = img.shape
    s = stem
    x = img.reshape(B, H // s, s, W // s, s).permute(0, 2, 4, 1, 3)
    x = x.reshape(B, s * s, H // s, W // s)
    pools = {1: 3, 2: 2, 4: 1}[s]

    def block(i, x):
        p = w[(f"_VGGBlock_{i}", "Conv_0", "kernel")], \
            w[(f"_VGGBlock_{i}", "Conv_0", "bias")]
        return F.relu(ops.conv(x, *p))

    for i in range(8):
        x = block(i, x)
        if i in (1, 3, 5) and pools > 0:
            pools -= 1
            x = F.max_pool2d(x, 2, 2)
    logits = ops.conv(block(8, x), w[("Conv_0", "kernel")],
                      w[("Conv_0", "bias")])
    prob = torch.softmax(logits, dim=1)[:, :64]
    Hc, Wc = prob.shape[-2:]
    heat = prob.reshape(B, 8, 8, Hc, Wc).permute(0, 3, 1, 4, 2)
    heat = heat.reshape(B, Hc * 8, Wc * 8)
    desc = ops.conv(block(9, x), w[("Conv_1", "kernel")],
                    w[("Conv_1", "bias")])
    desc = desc / torch.sqrt((desc * desc).sum(1, keepdim=True) + 1e-12)
    return heat, desc.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# LightGlue

def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def lightglue(w: dict, desc0, desc1, kn0, kn1, m0, m1, heads: int,
              ops: Ops):
    """desc (N, Din), normalised keypoints kn (N, 2), masks m (N,) of two
    sets -> (f0, f1, z0, z1): the final projections and the matchability
    logits.

    Input projection; a learned rotary encoding (cos and sin of the
    keypoints through a linear map to hd/2 frequencies, repeated) applied
    to queries and keys of self-attention; per layer self-attention of each
    set with a residual MLP on [x, message] (Linear 2d -> 2d, GELU, Linear
    2d -> d), then cross-attention of each updated set to the other with
    the same MLP form; all attention weights shared between the sets;
    masked queries get a zero message."""
    layers = sorted({k[0] for k in w if re.fullmatch(r"layer\d+", k[0])},
                    key=lambda s: int(s[5:]))
    d0 = ops.dense(desc0, w[("inp", "kernel")], w[("inp", "bias")])
    d1 = ops.dense(desc1, w[("inp", "kernel")], w[("inp", "bias")])
    freqs = w[("rope", "freqs", "kernel")]

    def rot(kn):
        f = torch.matmul(kn, freqs)
        emb = torch.cat([f, f], dim=-1)
        return torch.cos(emb), torch.sin(emb)

    r0, r1 = rot(kn0), rot(kn1)
    dim = d0.shape[-1]
    hd = dim // heads

    def attend(lw, name, x, src, mq, mk, rq=None, rk=None):
        def proj(t, p):
            y = ops.dense(t, lw[(name, p, "kernel")], lw[(name, p, "bias")])
            return y.unflatten(-1, (heads, hd)).transpose(-3, -2)
        q, k, v = proj(x, "q"), proj(src, "k"), proj(src, "v")
        if rq is not None:
            q = q * rq[0] + _rotate_half(q) * rq[1]
            k = k * rk[0] + _rotate_half(k) * rk[1]
        o = ops.attention(q, k, v, mk.expand(heads, -1))
        o = o.transpose(-3, -2).flatten(-2)
        o = ops.dense(o, lw[(name, "o", "kernel")], lw[(name, "o", "bias")])
        return torch.where(mq[:, None], o, 0.0)

    def mlp(lw, a, b, x, msg):
        h = _gelu(ops.dense(torch.cat([x, msg], -1), lw[(a, "kernel")],
                            lw[(a, "bias")]))
        return x + ops.dense(h, lw[(b, "kernel")], lw[(b, "bias")])

    for name in layers:
        lw = {k[1:]: v for k, v in w.items() if k[0] == name}
        d0 = mlp(lw, "Dense_0", "Dense_1", d0,
                 attend(lw, "self_attn", d0, d0, m0, m0, r0, r0))
        d1 = mlp(lw, "Dense_0", "Dense_1", d1,
                 attend(lw, "self_attn", d1, d1, m1, m1, r1, r1))
        c0 = attend(lw, "cross_attn", d0, d1, m0, m1)
        c1 = attend(lw, "cross_attn", d1, d0, m1, m0)
        d0 = mlp(lw, "Dense_2", "Dense_3", d0, c0)
        d1 = mlp(lw, "Dense_2", "Dense_3", d1, c1)
    f0 = ops.dense(d0, w[("final", "kernel")], w[("final", "bias")])
    f1 = ops.dense(d1, w[("final", "kernel")], w[("final", "bias")])
    mk, mb = w[("matchability", "kernel")], w[("matchability", "bias")]
    z0 = (torch.matmul(d0, mk) + mb)[..., 0]
    z1 = (torch.matmul(d1, mk) + mb)[..., 0]
    return f0, f1, z0, z1


def assignment(f0, f1, z0, z1, m0, m1, threshold: float = 0.0):
    """Dual softmax with matchability: score_ij = softmax over j of sim
    times softmax over i of sim times sigmoid(z0_i) sigmoid(z1_j), sim =
    f0 f1^T / sqrt(d), masked pairs at -1e9; a row's match is its best
    column when that column's best row is the row and the score exceeds
    `threshold` -> (matches0 (N,) long, -1 = none, mscores0 (N,))."""
    sim = torch.matmul(f0, f1.transpose(-1, -2)) / f0.shape[-1] ** 0.5
    sim = torch.where(m0[:, None] & m1[None, :], sim, NEG)
    logp = torch.log_softmax(sim, -1) + torch.log_softmax(sim, -2) \
        + F.logsigmoid(z0)[:, None] + F.logsigmoid(z1)[None, :]
    s0, nn0 = logp.max(-1)
    nn1 = logp.argmax(-2)
    ar = torch.arange(len(nn0), device=f0.device)
    s0 = s0.exp()
    ok = (nn1[nn0] == ar) & m0 & (s0 > threshold)
    return torch.where(ok, nn0, -1), torch.where(ok, s0, 0.0)


# ---------------------------------------------------------------------------
# The pair sub-pixel head

def pair_head(w: dict, patches0, patches1, desc0, desc1, score, ops: Ops,
              offset_range: float):
    """Per match, both (P, P) image patches, both descriptors and the
    match score -> an offset in (-range, range)^2 for the current keypoint:
    two dense layers with GELU, a third to 2, range * tanh."""
    x = torch.cat([patches0.flatten(-2), patches1.flatten(-2), desc0, desc1,
                   score[..., None]], dim=-1)
    x = _gelu(ops.dense(x, w[("Dense_0", "kernel")], w[("Dense_0", "bias")]))
    x = _gelu(ops.dense(x, w[("Dense_1", "kernel")], w[("Dense_1", "bias")]))
    x = ops.dense(x, w[("Dense_2", "kernel")], w[("Dense_2", "bias")])
    return offset_range * torch.tanh(x)
