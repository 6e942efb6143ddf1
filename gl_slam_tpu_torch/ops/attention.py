"""Fused masked multi-head attention for the matcher.

Counterpart of gl_slam_tpu/ops/attention.py. `attention_plain` is the plain
PyTorch version of the function (the JAX `attention_xla`, with a written-out
batch dimension); `attention_cuda` launches the hand-written flash-style
kernel in csrc/attention.cu, which replaces the Pallas `attention_pallas` /
`_attn_kernel`. `attention` takes the plain version only for CPU tensors: a
CUDA tensor launches the kernel or raises.

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
    out = torch.empty((*lead, H, Nq, dh), dtype=torch.float32,
                      device=q.device)
    if B * H == 0 or Nq == 0:
        return out
    if Nk == 0:
        raise ValueError("attention_cuda: no keys")
    lib = _build.load("attention")
    fn = lib.gl_attention_fwd
    fn.restype = _build.ctypes.c_int
    fn.argtypes = [_build.ctypes.c_void_p] * 5 + [_build.ctypes.c_int] * 5 \
        + [_build.ctypes.c_float, _build.ctypes.c_void_p]
    m8 = mask_k.view(torch.uint8)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(m8),
             _build.ptr(out), B * H, H, Nq, Nk, dh, float(scale),
             _build.stream_of(q))
    _build.LAUNCHES["attention"] += 1
    _build.check(err, "attention")
    return out


def attention(q, k, v, mask_k, scale: float):
    """Dispatch on the device: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.is_cuda:
        return attention_cuda(q, k, v, mask_k, scale)
    return attention_plain(q, k, v, mask_k, scale)
