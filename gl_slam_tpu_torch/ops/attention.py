"""Fused masked multi-head attention for the matcher.

Counterpart of gl_slam_tpu/ops/attention.py. `attention_plain` is the plain
PyTorch version of the function (the JAX `attention_xla`, with a written-out
batch dimension); `attention_cuda` launches the hand-written kernel in
csrc/attention.cu, which replaces the Pallas `attention_pallas` /
`_attn_kernel`. `attention` takes the plain version only for CPU tensors: a
CUDA tensor launches the kernel or raises.

The kernel gives each CTA one 128-row query tile of one (set, head). Where
those CTAs are too few to fill the card, `split_plan` splits the keys of
each query tile over a cluster of 2, 4 or 8 CTAs that combine their partial
softmax sums in the same launch.

Numerics: logits = q.k^T * scale accumulated in f32; masked keys are set to
-1e9 (not -inf, so a row with every key masked averages v uniformly); the
softmax divides by its sum clamped at 1e-20; probabilities are cast to v's
dtype before the product with v; the output is f32.
"""

from __future__ import annotations

import math

import torch

from . import _build

_NEG = -1e9
_HEAD_DIMS = (32, 64, 128)
Q_TILE = 128          # query rows per CTA (two consumer warpgroups)
SPLIT_KEY_TILE = 64   # keys per ring stage where the keys are split
LONG_KEY_TILE = 96    # keys per ring stage where each CTA takes all keys
MAX_SPLITS = 8        # the portable cluster size
FILL_CTAS = 64        # CTAs at which a split call runs fastest (PERF.md)
GRID_Z_MAX = 65535    # the CUDA grid's z limit (one z per (set, head))


def split_plan(BH: int, Nq: int, Nk: int) -> tuple[int, int, int]:
    """(query tile, key tile, key splits S) of the kernel for BH (set, head)
    pairs.

    With at least FILL_CTAS query tiles the keys are not split and a CTA
    walks them in 96-key tiles (fewer shared-memory bytes per product).
    Otherwise S doubles from 1 while fewer than FILL_CTAS CTAs would run,
    up to MAX_SPLITS, and only while every split keeps at least one 64-key
    tile (so each split holds a key below Nk). On the H100 a split call
    ran fastest at 64 CTAs (128 consumer warpgroups) at each re-observation
    shape, ahead of 128 CTAs."""
    ctas = -(-Nq // Q_TILE) * BH
    if ctas >= FILL_CTAS:
        return Q_TILE, LONG_KEY_TILE, 1
    tiles = -(-Nk // SPLIT_KEY_TILE)
    splits = 1
    while (splits < MAX_SPLITS and ctas * splits < FILL_CTAS
           and 2 * splits <= tiles):
        splits *= 2
    return Q_TILE, SPLIT_KEY_TILE, splits


def split_ranges(Nk: int, splits: int,
                 key_tile: int = SPLIT_KEY_TILE) -> list[tuple[int, int]]:
    """The [start, stop) key range of each split: split s takes key tiles
    s T / S to (s + 1) T / S of the T = ceil(Nk / key_tile) tiles, as the
    kernel does."""
    tiles = -(-Nk // key_tile)
    return [(s * tiles // splits * key_tile,
             min((s + 1) * tiles // splits * key_tile, Nk))
            for s in range(splits)]


def attention_plain(q, k, v, mask_k, scale: float):
    """q (..., H, Nq, dh), k/v (..., H, Nk, dh), mask_k (..., Nk) bool."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = torch.where(mask_k[..., None, None, :], logits, _NEG)
    attn = torch.softmax(logits, dim=-1)
    return torch.matmul(attn.to(v.dtype).float(), v.float())


def attention_tolerance(q, k, v, mask_k, scale: float):
    """Elementwise bound on |attention_cuda - attention_plain|, same shape as
    the output.

    With S = sum_j p_ij |v_jd| (p the plain softmax):
      - both versions round each weight to bf16 once (the kernel before the
        1/sum, the plain version after it), each to 2^-8 relative: 2^-7 S;
      - the logits are dh-term f32 dot products summed in another order
        (tensor-core adds counted at 2^-22 each): |logit error| <= delta_i =
        dh 2^-22 scale max_j sum_d |q_id k_jd|, which moves each normalised
        weight by <= 2 delta_i relative;
      - the sum and p.v run over Nk f32 terms: Nk 2^-22 S.

    The kernel's order stays inside these terms. It rounds each weight
    exp(l_ij - m) to bf16 once, with m the running max of its split at that
    key tile: a relative rounding (bf16 has f32's exponent range), so 2^-8
    whatever m is. Each correction exp(m_old - m_new), and each split's
    combine weight w_s = exp(m_s - M), multiplies the split's O and its sum
    l by the same f32 number, so it cancels in O / l up to one f32 rounding
    of each product: with at most Nk / 64 tile corrections and S <= 8
    combine terms, fewer than Nk roundings of 2^-24, inside the Nk 2^-22 S
    term. A split whose keys are all masked carries m_s = -1e9 and weighs
    exp(-1e9 - M) = 0 unless every key of the set is masked, when all
    m_s = -1e9, w_s = 1 and the result is the mean of v, as in the plain
    version.
    """
    dh, Nk = q.shape[-1], k.shape[-2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = torch.where(mask_k[..., None, None, :], logits, _NEG)
    S = torch.matmul(torch.softmax(logits, dim=-1), v.float().abs())
    del logits
    dot = torch.matmul(q.float().abs(), k.float().abs().transpose(-1, -2))
    delta = dh * 2.0 ** -22 * scale * dot.amax(-1, keepdim=True)
    return (2.0 ** -7 + 2 * delta + Nk * 2.0 ** -22) * S + 1e-6


def attention_cuda(q, k, v, mask_k, scale: float):
    """The CUDA kernel. bf16 q/k/v, contiguous, head dim in {32, 64, 128}."""
    lead = q.shape[:-3]
    H, Nq, dh = q.shape[-3:]
    Nk = k.shape[-2]
    for name, t in (("q", q), ("k", k), ("v", v), ("mask_k", mask_k)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"attention_cuda: {name} must be on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"attention_cuda: {name} must be contiguous")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("attention_cuda: q, k, v must be bfloat16")
    if mask_k.dtype != torch.bool:
        raise ValueError("attention_cuda: mask_k must be bool")
    if (k.shape != v.shape or k.shape[:-2] != q.shape[:-2]
            or k.shape[-1] != dh or mask_k.shape != (*lead, Nk)):
        raise ValueError(f"attention_cuda: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"mask{tuple(mask_k.shape)}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"attention_cuda: head dim {dh} not in {_HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention_cuda: q, k, v must be 16-byte aligned")
    B = math.prod(lead)
    # grid z holds the (set, head) pairs; the tensor maps and the output
    # offsets are built for fewer than 2^31 elements per operand
    if B * H > GRID_Z_MAX:
        raise ValueError(f"attention_cuda: {B * H} (set, head) pairs > "
                         f"{GRID_Z_MAX}")
    if B * H * max(Nq, Nk) * dh >= 2 ** 31:
        raise ValueError("attention_cuda: an operand holds 2^31 elements "
                         "or more")
    out = torch.empty((*lead, H, Nq, dh), dtype=torch.float32,
                      device=q.device)
    if B * H == 0 or Nq == 0:
        return out
    if Nk == 0:
        raise ValueError("attention_cuda: no keys")
    _, key_tile, splits = split_plan(B * H, Nq, Nk)
    lib = _build.load("attention")
    fn = lib.gl_attention_fwd
    fn.restype = _build.ctypes.c_int
    fn.argtypes = [_build.ctypes.c_void_p] * 5 + [_build.ctypes.c_int] * 5 \
        + [_build.ctypes.c_float] + [_build.ctypes.c_int] * 2 \
        + [_build.ctypes.c_void_p]
    m8 = mask_k.view(torch.uint8)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(m8),
             _build.ptr(out), B * H, H, Nq, Nk, dh, float(scale), key_tile,
             splits, _build.stream_of(q))
    _build.LAUNCHES["attention"] += 1
    _build.check(err, "attention")
    return out


def attention(q, k, v, mask_k, scale: float):
    """Dispatch on the device: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.is_cuda:
        return attention_cuda(q, k, v, mask_k, scale)
    return attention_plain(q, k, v, mask_k, scale)
