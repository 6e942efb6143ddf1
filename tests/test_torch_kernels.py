"""The port's two kernel modules against the JAX package, on the CPU.

gl_slam_tpu_torch/ops/{attention,assignment}.py each hold a CUDA kernel
and its plain PyTorch version. Here (no card) the plain versions are held
against the JAX reference: the Pallas kernels in interpret mode and their
XLA versions. Inputs come from a numpy seed; the JAX side runs in float32
at "highest" matmul precision (tests/conftest.py). The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu.ops import assignment as j_asg
from gl_slam_tpu.ops import attention as j_attn
from gl_slam_tpu_torch.ops import _build
from gl_slam_tpu_torch.ops import assignment as t_asg
from gl_slam_tpu_torch.ops import attention as t_attn

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

# Float32 on both sides; the sums run in other orders (XLA vs ATen), so
# values agree to float32 rounding of O(1)-O(10) quantities.
TOL = 1e-4


def _attn_inputs(rng, lead, H, Nq, Nk, dh):
    q = rng.standard_normal(lead + (H, Nq, dh)).astype(np.float32)
    k = rng.standard_normal(lead + (H, Nk, dh)).astype(np.float32)
    v = rng.standard_normal(lead + (H, Nk, dh)).astype(np.float32)
    mask = rng.uniform(size=lead + (Nk,)) < 0.7
    return q, k, v, mask


@pytest.mark.parametrize("lead,Nq,Nk", [((), 40, 40), ((), 24, 56),
                                        ((3,), 32, 32), ((2, 2), 16, 48)])
def test_attention_plain_matches_jax(lead, Nq, Nk):
    rng = np.random.default_rng(0)
    H, dh = 2, 32
    q, k, v, mask = _attn_inputs(rng, lead, H, Nq, Nk, dh)
    flat = mask.reshape(-1, Nk)
    flat[0] = False                  # a set whose keys are all masked
    scale = 1.0 / np.sqrt(dh)
    got = t_attn.attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                           scale).numpy()
    qs, ks, vs = (a.reshape((-1, H) + a.shape[-2:]) for a in (q, k, v))
    ref_xla = np.stack([np.asarray(j_attn.attention_xla(
        qs[i], ks[i], vs[i], flat[i], scale)) for i in range(len(flat))])
    ref_pl = np.stack([np.asarray(j_attn.attention_pallas(
        qs[i], ks[i], vs[i], flat[i], scale, tile_q=16, interpret=True))
        for i in range(len(flat))])
    got = got.reshape(ref_xla.shape)
    np.testing.assert_allclose(got, ref_xla, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, ref_pl, atol=TOL, rtol=TOL)
    # All keys masked: the -1e9 sentinel gives the uniform mean of v.
    np.testing.assert_allclose(got[0], np.broadcast_to(
        vs[0].mean(1, keepdims=True), got[0].shape), atol=TOL)


def test_attention_plain_bf16_rounds_p_like_jax():
    """bf16 operands: p is rounded to bf16 before the product with v on
    both sides; a p on a rounding boundary may round the other way under
    another summation order, which attention_tolerance's 2^-7 sum_j p_ij
    |v_jd| term bounds elementwise."""
    rng = np.random.default_rng(1)
    q, k, v, mask = _attn_inputs(rng, (), 2, 48, 40, 32)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = np.asarray(j_attn.attention_xla(*bf, mask, 0.125))
    tq = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in bf]
    got = t_attn.attention(*tq, torch.from_numpy(mask), 0.125)
    assert got.dtype == torch.float32
    tol = t_attn.attention_tolerance(*tq, torch.from_numpy(mask), 0.125)
    assert bool(((got - torch.from_numpy(ref)).abs() <= tol).all())


def _attn_kernel_order(q, k, v, mask, scale):
    """The CUDA kernel's arithmetic in plain torch: exp(l - max) rounded to
    bf16 before the product with v, divided by the sum of the unrounded
    exponentials afterwards."""
    lg = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lg = torch.where(mask[..., None, None, :], lg, -1e9)
    e = torch.exp(lg - lg.amax(-1, keepdim=True))
    return torch.matmul(e.to(torch.bfloat16).float(), v.float()) \
        / e.sum(-1, keepdim=True)


def test_attention_tolerance_covers_kernel_rounding_and_no_more():
    """attention_tolerance bounds the gap between the kernel's rounding order
    and the plain version's, and a dropped key tile lies far outside it."""
    g = torch.Generator().manual_seed(6)
    k, v = (torch.randn(3, 2, 200, 64, generator=g).to(torch.bfloat16)
            for _ in range(2))
    q = (0.75 * k.float()[..., (torch.arange(96) * 97) % 200, :]).to(
        torch.bfloat16)                  # each query aims at one key
    mask = torch.rand(3, 200, generator=g) < 0.8
    mask[1] = False                      # every key masked
    ref = t_attn.attention_plain(q, k, v, mask, 0.125)
    tol = t_attn.attention_tolerance(q, k, v, mask, 0.125)
    assert bool(((_attn_kernel_order(q, k, v, mask, 0.125) - ref).abs()
                 <= tol).all())
    assert float(ref.abs().median() / tol.median()) >= 10
    dropped = mask.clone()
    dropped[:, 64:128] = False           # one 64-key tile lost
    gap = (_attn_kernel_order(q, k, v, dropped, 0.125) - ref).abs() / tol
    assert float(gap.max()) > 10


def _asg_inputs(rng, B, N, M, Df):
    f0 = rng.standard_normal((B, N, Df)).astype(np.float32) / 4
    f1 = rng.standard_normal((B, M, Df)).astype(np.float32) / 4
    z0 = rng.standard_normal((B, N)).astype(np.float32)
    z1 = rng.standard_normal((B, M)).astype(np.float32)
    m0 = rng.uniform(size=(B, N)) < 0.85
    m1 = rng.uniform(size=(B, M)) < 0.85
    m0[0, 2] = False                 # fully masked row
    m1[0, 5] = False                 # fully masked column
    m1[-1, :] = False                # a pair whose columns are all masked
    m1[-1, 0] = True
    # Ties: duplicated column / row with equal matchability
    f1[0, 9], z1[0, 9], m1[0, [4, 9]] = f1[0, 4], z1[0, 4], True
    f1[0, 4] = f1[0, 9] = f0[0, 1] * 3
    f0[0, 20], z0[0, 20], m0[0, [7, 20]] = f0[0, 7], z0[0, 7], True
    f0[0, 7] = f0[0, 20] = f1[0, 11] * 3
    m0[0, 1] = m1[0, 11] = True
    return f0, f1, z0, z1, m0, m1


def test_fused_reductions_plain_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    B, N, M, Df = 2, 48, 40, 64
    f0, f1, z0, z1, m0, m1 = _asg_inputs(rng, B, N, M, Df)
    scale = 1.0 / np.sqrt(Df)
    c0 = np.asarray(jax.nn.log_sigmoid(z0))
    c1 = np.asarray(jax.nn.log_sigmoid(z1))
    got = t_asg.fused_reductions(*(torch.from_numpy(a) for a in
                                   (f0, f1, c0, c1, m0, m1)), scale)
    for b in range(B):
        # tile_q=16: three row tiles, so the kernel's column carry runs
        ref = j_asg._fused_reductions(f0[b], f1[b], c0[b], c1[b], m0[b],
                                      m1[b], scale, 16, True)
        for name, g, r in zip(("nn0", "v0", "lse_r", "nn1", "v1", "lse_c"),
                              got, ref):
            if name.startswith("nn"):
                np.testing.assert_array_equal(g[b].numpy(), np.asarray(r),
                                              err_msg=name)
            else:
                np.testing.assert_allclose(g[b].numpy(), np.asarray(r),
                                           atol=TOL, rtol=TOL, err_msg=name)
    nn0, nn1 = got[0][0].numpy(), got[3][0].numpy()
    assert nn0[1] == 4 and nn1[11] == 7      # ties to the smaller index


def test_fused_assignment_matches_jax_xla():
    rng = np.random.default_rng(3)
    B, N, M, Df = 2, 40, 56, 64
    f0, f1, z0, z1, m0, m1 = _asg_inputs(rng, B, N, M, Df)
    scale = 1.0 / np.sqrt(Df)
    got = t_asg.fused_assignment(*(torch.from_numpy(a) for a in
                                   (f0, f1, z0, z1, m0, m1)), scale, 0.0)
    for b in range(B):
        ref = j_asg.fused_assignment(f0[b], f1[b], z0[b], z1[b], m0[b],
                                     m1[b], scale, 0.0, use_pallas=False)
        np.testing.assert_array_equal(got.matches0[b].numpy(),
                                      np.asarray(ref.matches0))
        np.testing.assert_array_equal(got.matches1[b].numpy(),
                                      np.asarray(ref.matches1))
        np.testing.assert_allclose(got.mscores0[b].numpy(),
                                   np.asarray(ref.mscores0), atol=1e-5)
        np.testing.assert_allclose(got.mscores1[b].numpy(),
                                   np.asarray(ref.mscores1), atol=1e-5)
    assert int(got.matches0[0, 1]) == 4      # the constructed match


def test_wrappers_take_plain_version_only_for_cpu_tensors():
    """A CPU tensor runs the plain version and counts no launch; a CUDA
    tensor never reaches the plain version (checked on the card below)."""
    _build.reset_launch_counts()
    rng = np.random.default_rng(4)
    q, k, v, mask = _attn_inputs(rng, (), 2, 8, 8, 32)
    t_attn.attention(*(torch.from_numpy(a) for a in (q, k, v, mask)), 0.1)
    f0, f1, z0, z1, m0, m1 = _asg_inputs(rng, 1, 24, 24, 64)
    t_asg.fused_assignment(*(torch.from_numpy(a) for a in
                             (f0, f1, z0, z1, m0, m1)), 0.125)
    assert _build.LAUNCHES == {"attention": 0, "assignment": 0}


def test_cuda_wrappers_reject_cpu_tensors():
    q = torch.zeros(2, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        t_attn.attention_cuda(q, q, q, torch.ones(8, dtype=torch.bool), 0.1)
    f = torch.zeros(8, 64, dtype=torch.bfloat16)
    c = torch.zeros(8)
    m = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        t_asg.fused_reductions_cuda(f, f, c, c, m, m, 0.1)
