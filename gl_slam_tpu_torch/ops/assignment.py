"""Fused dual-softmax assignment head — the matcher epilogue.

Counterpart of gl_slam_tpu/ops/assignment.py. With
  lse_r[i] = logsumexp_j sim[i,j],   lse_c[j] = logsumexp_i sim[i,j],
  c0 = log_sigmoid(z0),               c1 = log_sigmoid(z1),
the assignment score is exp(2 sim - lse_r - lse_c + c0 + c1), so the
mutual-NN matches need only per-row and per-column reductions:
  nn0[i] = argmax_j (2 sim[i,j] + c1[j] - lse_c[j])
  nn1[j] = argmax_i (2 sim[i,j] + c0[i] - lse_r[i])
and no (N, M) tensor has to exist.

`fused_reductions_plain` is the plain PyTorch version of those reductions
(the JAX `_fused_reductions`, with a leading batch dimension);
`fused_reductions_cuda` launches the hand-written kernel in
csrc/assignment.cu that replaces the Pallas `_assign_kernel`. Masked pairs
are -1e9 in the logits, masked rows/columns are excluded at -1e9 in the
argmax objectives, and argmax ties go to the smallest index. The mutual-NN
and threshold epilogue (`fused_assignment`) stays in PyTorch.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..models.lightglue import MatchOutput
from . import _build

_NEG = -1e9
# The column-argmax carry of the JAX kernel starts at f32(-1e9 - 1) = -1e9
# with index 0 and only a strictly larger value replaces it.
_CBEST0 = float(torch.tensor(_NEG - 1.0, dtype=torch.float32))
_FEAT_DIMS = (64, 128, 256)


def fused_reductions_plain(f0, f1, c0, c1, m0, m1, scale: float):
    """f0 (..., N, Df), f1 (..., M, Df); c0/m0 (..., N); c1/m1 (..., M).

    Returns (nn0, v0, lse_r, nn1, v1, lse_c)."""
    sim = torch.matmul(f0.float(), f1.float().transpose(-1, -2))
    pair = m0[..., :, None] & m1[..., None, :]
    l1 = torch.where(pair, sim * scale, _NEG)
    rmx = l1.amax(-1)
    lse_r = rmx + torch.log(torch.exp(l1 - rmx[..., None]).sum(-1))
    cmax = l1.amax(-2)
    csum = torch.exp(l1 - cmax[..., None, :]).sum(-2)
    lse_c = cmax + torch.log(torch.clamp_min(csum, 1e-30))
    l2 = torch.where(pair, sim * (2.0 * scale), _NEG)
    cc1 = torch.where(m1, c1 - lse_c, _NEG)
    gr = l2 + cc1[..., None, :]
    v0, nn0 = gr.amax(-1), gr.argmax(-1)
    r0 = torch.where(m0, c0 - lse_r, _NEG)
    gc = l2 + r0[..., :, None]
    cb, ci = gc.amax(-2), gc.argmax(-2)
    better = cb > _CBEST0
    v1 = torch.where(better, cb, _CBEST0)
    nn1 = torch.where(better, ci, 0)
    return (nn0.to(torch.int32), v0, lse_r, nn1.to(torch.int32), v1, lse_c)


def fused_reductions_cuda(f0, f1, c0, c1, m0, m1, scale: float):
    """The CUDA kernel: four launches (row/column partials, column combine,
    argmax partials, argmax combine), each added to the launch count. bf16
    features, f32 c0/c1, bool masks, all contiguous on one device; feature
    dim in {64, 128, 256}."""
    lead = f0.shape[:-2]
    N, Df = f0.shape[-2:]
    M = f1.shape[-2]
    args = (("f0", f0), ("f1", f1), ("c0", c0), ("c1", c1), ("m0", m0),
            ("m1", m1))
    for name, t in args:
        if not t.is_cuda or t.device != f0.device:
            raise ValueError(f"assignment_cuda: {name} must be on "
                             f"{f0.device}")
        if not t.is_contiguous():
            raise ValueError(f"assignment_cuda: {name} must be contiguous")
    if f0.dtype != torch.bfloat16 or f1.dtype != torch.bfloat16:
        raise ValueError("assignment_cuda: f0, f1 must be bfloat16")
    if c0.dtype != torch.float32 or c1.dtype != torch.float32:
        raise ValueError("assignment_cuda: c0, c1 must be float32")
    if m0.dtype != torch.bool or m1.dtype != torch.bool:
        raise ValueError("assignment_cuda: m0, m1 must be bool")
    if (f1.shape != (*lead, M, Df) or c0.shape != (*lead, N)
            or m0.shape != (*lead, N) or c1.shape != (*lead, M)
            or m1.shape != (*lead, M)):
        raise ValueError("assignment_cuda: inconsistent shapes")
    if Df not in _FEAT_DIMS:
        raise ValueError(f"assignment_cuda: feature dim {Df} not in "
                         f"{_FEAT_DIMS}")
    if N == 0 or M == 0:
        raise ValueError("assignment_cuda: empty set")
    if f0.data_ptr() % 16 or f1.data_ptr() % 16:
        raise ValueError("assignment_cuda: f0, f1 must be 16-byte aligned")
    B = math.prod(lead)
    dev = f0.device
    i32, f32 = torch.int32, torch.float32
    nn0 = torch.empty((*lead, N), dtype=i32, device=dev)
    v0 = torch.empty((*lead, N), dtype=f32, device=dev)
    lse_r = torch.empty((*lead, N), dtype=f32, device=dev)
    nn1 = torch.empty((*lead, M), dtype=i32, device=dev)
    v1 = torch.empty((*lead, M), dtype=f32, device=dev)
    lse_c = torch.empty((*lead, M), dtype=f32, device=dev)
    if B == 0:
        return nn0, v0, lse_r, nn1, v1, lse_c
    row_tiles = (N + 63) // 64
    part_a = torch.empty((B, row_tiles, M), dtype=f32, device=dev)
    part_b = torch.empty((B, row_tiles, M), dtype=f32, device=dev)
    part_i = torch.empty((B, row_tiles, M), dtype=i32, device=dev)
    cc1 = torch.empty((B, M), dtype=f32, device=dev)
    lib = _build.load("assignment")
    fn = lib.gl_assignment_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    P = _build.ptr
    launched = ctypes.c_int(0)
    err = fn(P(f0), P(f1), P(c0), P(c1), P(m0.view(torch.uint8)),
             P(m1.view(torch.uint8)), P(nn0), P(v0), P(lse_r), P(nn1),
             P(v1), P(lse_c), P(part_a), P(part_b), P(part_i), P(cc1),
             B, N, M, Df, float(scale), _build.stream_of(f0),
             ctypes.byref(launched))
    _build.LAUNCHES["assignment"] += launched.value
    _build.check(err, "assignment")
    return nn0, v0, lse_r, nn1, v1, lse_c


def fused_reductions(f0, f1, c0, c1, m0, m1, scale: float):
    """Dispatch on the device: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if f0.is_cuda:
        return fused_reductions_cuda(f0, f1, c0, c1, m0, m1, scale)
    return fused_reductions_plain(f0, f1, c0, c1, m0, m1, scale)


def fused_assignment(f0, f1, z0, z1, m0, m1, scale: float,
                     threshold: float = 0.0) -> MatchOutput:
    """Matcher assignment directly from final-projection features.

    f0 (..., N, Df), f1 (..., M, Df): the `final` Dense outputs, with
    sim = f0 @ f1^T * scale. Returns MatchOutput with `scores=None`."""
    c0 = F.logsigmoid(z0.float())
    c1 = F.logsigmoid(z1.float())
    nn0, v0, lse_r, nn1, v1, lse_c = fused_reductions(
        f0.contiguous(), f1.contiguous(), c0.contiguous(), c1.contiguous(),
        m0.contiguous(), m1.contiguous(), scale)
    N = f0.shape[-2]
    M = f1.shape[-2]
    s0 = torch.exp(v0 + c0 - lse_r)
    s1 = torch.exp(v1 + c1 - lse_c)
    nn0c = nn0.long().clamp(0, M - 1)
    nn1c = nn1.long().clamp(0, N - 1)
    ar0 = torch.arange(N, device=f0.device)
    ar1 = torch.arange(M, device=f0.device)
    mutual0 = torch.gather(nn1c, -1, nn0c) == ar0
    ok0 = mutual0 & m0 & (s0 > threshold) & (nn0 < M)
    mutual1 = torch.gather(nn0c, -1, nn1c) == ar1
    ok1 = mutual1 & m1 & (s1 > threshold) & (nn1 < 2 ** 30)
    return MatchOutput(
        matches0=torch.where(ok0, nn0c, -1).to(torch.int32),
        mscores0=torch.where(ok0, s0, 0.0),
        matches1=torch.where(ok1, nn1c, -1).to(torch.int32),
        mscores1=torch.where(ok1, s1, 0.0),
        scores=None)
