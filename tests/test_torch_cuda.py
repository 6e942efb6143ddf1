"""The CUDA kernels against their plain PyTorch versions, on the card.

Without a CUDA device every test here skips: the kernels have no CPU mode.
The file imports no JAX, so it also runs on the card's machine, without the
JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gl_slam_tpu_torch.ops import _build
from gl_slam_tpu_torch.ops import assignment as t_asg
from gl_slam_tpu_torch.ops import attention as t_attn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("lead,Nq,Nk,dh", [((3,), 100, 70, 128),
                                          ((), 64, 200, 64),
                                          ((2, 2), 17, 9, 32)])
def test_attention_kernel_matches_plain(cuda_device, lead, Nq, Nk, dh):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(*lead, 2, n, dh, generator=g, device=cuda_device)
               .to(torch.bfloat16) for n in (Nq, Nk, Nk))
    mask = torch.rand(*lead, Nk, generator=g, device=cuda_device) < 0.6
    mask.view(-1, Nk)[0] = False           # a set with every key masked
    before = _build.LAUNCHES["attention"]
    out = t_attn.attention(q, k, v, mask, dh ** -0.5)
    assert _build.LAUNCHES["attention"] == before + 1
    ref = t_attn.attention_plain(q, k, v, mask, dh ** -0.5)
    # Elementwise bound from the roundings of the two versions (see
    # attention_tolerance): 2^-7 sum_j p_ij |v_jd| plus f32 terms.
    tol = t_attn.attention_tolerance(q, k, v, mask, dh ** -0.5)
    assert bool(((out - ref).abs() <= tol).all())


def _asg_inputs(rng, B, N, M, Df):
    f0 = rng.standard_normal((B, N, Df)).astype(np.float32) / 4
    f1 = rng.standard_normal((B, M, Df)).astype(np.float32) / 4
    z0 = rng.standard_normal((B, N)).astype(np.float32)
    z1 = rng.standard_normal((B, M)).astype(np.float32)
    m0 = rng.uniform(size=(B, N)) < 0.85
    m1 = rng.uniform(size=(B, M)) < 0.85
    m0[0, 2] = m1[0, 5] = False            # fully masked row and column
    # Row 1 prefers columns 4 = 9 (duplicates), column 11 rows 7 = 20.
    f1[0, 4] = f1[0, 9] = f0[0, 1] * 4
    z1[0, 4] = z1[0, 9] = 5.0
    f0[0, 7] = f0[0, 20] = f1[0, 11] * 4
    z0[0, 7] = z0[0, 20] = 5.0
    m0[0, [1, 7, 20]] = True
    m1[0, [4, 9, 11]] = True
    return f0, f1, z0, z1, m0, m1


@pytest.mark.parametrize("B,N,M,Df", [(2, 130, 90, 256), (1, 64, 300, 128)])
def test_assignment_kernel_matches_plain(cuda_device, B, N, M, Df):
    arrs = _asg_inputs(np.random.default_rng(5), B, N, M, Df)
    f0, f1, z0, z1, m0, m1 = (torch.from_numpy(a).to(cuda_device)
                              for a in arrs)
    f0, f1 = f0.to(torch.bfloat16), f1.to(torch.bfloat16)
    c0 = torch.nn.functional.logsigmoid(z0)
    c1 = torch.nn.functional.logsigmoid(z1)
    before = _build.LAUNCHES["assignment"]
    got = t_asg.fused_reductions(f0, f1, c0, c1, m0, m1, Df ** -0.5)
    assert _build.LAUNCHES["assignment"] == before + 4   # kernels per call
    ref = t_asg.fused_reductions_plain(f0, f1, c0, c1, m0, m1, Df ** -0.5)
    names = ("nn0", "v0", "lse_r", "nn1", "v1", "lse_c")
    for name, g_, r_ in zip(names, got, ref):
        if name.startswith("nn"):
            # indices may differ only at near-ties of the objective
            assert float((g_ != r_).float().mean()) < 0.01, name
        else:
            # f32 sums of the same bf16 products in another order
            assert float((g_ - r_).abs().max()) <= 1e-3, name
    assert int(got[0][0, 1]) == 4 and int(got[3][0, 11]) == 7   # ties


def test_kernels_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros(2, 8, 48, dtype=torch.bfloat16, device=cuda_device)
    m = torch.ones(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        t_attn.attention_cuda(q, q, q, m, 0.1)
    with pytest.raises(ValueError, match="bfloat16"):
        t_attn.attention_cuda(q.float(), q.float(), q.float(), m, 0.1)
