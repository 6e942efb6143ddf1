"""The port's three kernel modules against the JAX package, on the CPU.

gl_slam_tpu_torch/ops/{attention,assignment,nms}.py each hold a CUDA kernel
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
from gl_slam_tpu.ops import nms as j_nms
from gl_slam_tpu_torch.ops import _build
from gl_slam_tpu_torch.ops import assignment as t_asg
from gl_slam_tpu_torch.ops import attention as t_attn
from gl_slam_tpu_torch.ops import nms as t_nms

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


def _attn_kernel_order(q, k, v, mask, scale, splits=1,
                       key_tile=t_attn.SPLIT_KEY_TILE):
    """The CUDA kernel's arithmetic in plain torch. The keys are cut into
    `splits` contiguous ranges of whole key tiles (ops/attention.
    split_ranges); each split walks its tiles with a running max m, rounds
    exp(l - m) to bf16 before the product with v and keeps the sum of the
    unrounded exponentials, rescaling both by exp(m_old - m_new) when m
    grows; the splits then combine with weights exp(m_s - max_s m_s)."""
    lg = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lg = torch.where(mask[..., None, None, :], lg, -1e9)
    vf = v.float()
    parts = []
    for a, b in t_attn.split_ranges(k.shape[-2], splits, key_tile):
        m = torch.full(lg.shape[:-1] + (1,), -torch.inf)
        l = torch.zeros_like(m)
        o = torch.zeros(lg.shape[:-1] + (v.shape[-1],))
        for j in range(a, b, key_tile):
            x = lg[..., j:min(j + key_tile, b)]
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(x - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + torch.matmul(p.to(torch.bfloat16).float(),
                                        vf[..., j:j + x.shape[-1], :])
            m = m_new
        parts.append((m, l, o))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    L = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    O = sum(wi * o for wi, (_, _, o) in zip(w, parts))
    return O / L.clamp_min(1e-20)


def test_attention_tolerance_covers_kernel_rounding_and_no_more():
    """attention_tolerance bounds the gap between the kernel's rounding order
    and the plain version's at every key split the kernel takes, with a
    split made only of masked keys and a set with every key masked; a
    dropped key tile lies far outside it."""
    g = torch.Generator().manual_seed(6)
    kt = t_attn.SPLIT_KEY_TILE
    Nk = 8 * kt - 24                     # 8 key tiles, the last one ragged
    k, v = (torch.randn(3, 2, Nk, 64, generator=g).to(torch.bfloat16)
            for _ in range(2))
    q = (0.75 * k.float()[..., (torch.arange(96) * 97) % Nk, :]).to(
        torch.bfloat16)                  # each query aims at one key
    mask = torch.rand(3, Nk, generator=g) < 0.8
    mask[1] = False                      # every key masked
    mask[2, :2 * kt] = False             # the first split at S = 4, 8
    ref = t_attn.attention_plain(q, k, v, mask, 0.125)
    tol = t_attn.attention_tolerance(q, k, v, mask, 0.125)
    # outputs stand far above the bound (the all-masked set is held to
    # the mean of v below)
    assert float(ref[[0, 2]].abs().median() / tol[[0, 2]].median()) >= 10
    dropped = mask.clone()
    dropped[:, 3 * kt:4 * kt] = False    # one key tile lost
    # the unsplit walk in long key tiles, and the splits in short ones
    for splits, key_tile in ((1, t_attn.LONG_KEY_TILE), (1, kt), (2, kt),
                             (4, kt), (8, kt)):
        got = _attn_kernel_order(q, k, v, mask, 0.125, splits, key_tile)
        assert bool(((got - ref).abs() <= tol).all()), splits
        # every key masked: the uniform mean of v
        torch.testing.assert_close(got[1], v[1].float().mean(
            -2, keepdim=True).expand_as(got[1]), rtol=0, atol=1e-5)
        gap = (_attn_kernel_order(q, k, v, dropped, 0.125, splits, key_tile)
               - ref).abs() / tol
        assert float(gap.max()) > 10, splits


# The kernel's path shapes (ops/attention callers at flagship width: 2
# heads; the prologue's 8 pairs x 2 sets) and ragged ones.
# The multi-stream chunk's shapes at S streams: S x 8 pairs x 2 sets x 2
# heads in the prologue, S x 2 heads in re-observation (S = 4 and 16).
PLAN_SHAPES = [("prologue", 32, 2048, 2048), ("reobs", 2, 1024, 1024),
               ("reobs", 2, 2048, 2048), ("reobs", 2, 1024, 2048),
               ("reobs", 2, 2048, 1024),
               ("prologue", 128, 2048, 2048), ("prologue", 512, 2048, 2048),
               ("reobs", 8, 1024, 1024), ("reobs", 8, 2048, 2048),
               ("reobs", 8, 1024, 2048), ("reobs", 8, 2048, 1024),
               ("reobs", 32, 1024, 1024), ("reobs", 32, 2048, 2048),
               ("reobs", 32, 1024, 2048), ("reobs", 32, 2048, 1024),
               ("ragged", 2, 40, 9),
               ("ragged", 6, 17, 70), ("ragged", 2, 100, 200),
               ("ragged", 1, 1, 200)]


@pytest.mark.parametrize("kind,BH,Nq,Nk", PLAN_SHAPES)
def test_split_plan_fills_the_card_and_keeps_keys_in_every_split(kind, BH,
                                                                 Nq, Nk):
    q_tile, key_tile, splits = t_attn.split_plan(BH, Nq, Nk)
    assert q_tile == t_attn.Q_TILE and splits in (1, 2, 4, 8)
    assert key_tile == (t_attn.LONG_KEY_TILE if splits == 1 and
                        -(-Nq // q_tile) * BH >= t_attn.FILL_CTAS
                        else t_attn.SPLIT_KEY_TILE)
    ranges = t_attn.split_ranges(Nk, splits, key_tile)
    assert len(ranges) == splits and ranges[0][0] == 0
    assert ranges[-1][1] == Nk
    for (a, b), (c, _) in zip(ranges, ranges[1:] + [(Nk, Nk)]):
        assert a < b <= Nk and b == c   # contiguous, each below Nk
        assert a % key_tile == 0
    ctas = -(-Nq // q_tile) * BH * splits
    if kind == "prologue":
        assert splits == 1 and key_tile == t_attn.LONG_KEY_TILE
    if kind == "reobs":
        # A CTA holds two 64-row consumer warpgroups: 64 CTAs give 128
        # warpgroups, about one per SM, the fastest split measured.
        assert ctas * q_tile // 64 >= 128
    # no more splits than that needs
    assert splits == 1 or ctas // 2 < t_attn.FILL_CTAS


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


# The assignment kernel's path shapes (prologue, bootstrap, re-observation
# at flagship width) and ragged ones.
# The multi-stream chunk's shapes at S = 4 and 16 streams: S x 8 prologue
# pairs, S re-observation sets ("streams": the card is full either way).
ASG_PLAN_SHAPES = [("prologue", 8, 2048, 2048), ("bootstrap", 1, 2048, 2048),
                   ("reobs", 1, 1024, 2048),
                   ("prologue", 32, 2048, 2048), ("prologue", 128, 2048, 2048),
                   ("streams", 4, 1024, 2048), ("streams", 16, 1024, 2048),
                   ("ragged", 1, 40, 65),
                   ("ragged", 3, 1000, 777), ("ragged", 1, 1, 64),
                   ("ragged", 2, 130, 90), ("ragged", 1, 200, 1000)]


@pytest.mark.parametrize("kind,B,N,M", ASG_PLAN_SHAPES)
def test_assign_plan_fills_the_card(kind, B, N, M):
    row_tile, col_tile, splits = t_asg.assign_plan(B, N, M)
    assert (row_tile, col_tile) == (t_asg.ROW_TILE, t_asg.COL_TILE)
    assert splits >= 1 and splits & (splits - 1) == 0
    # the kernel cuts the columns as the attention kernel cuts its keys
    ranges = t_attn.split_ranges(M, splits, col_tile)
    assert len(ranges) == splits and ranges[0][0] == 0
    assert ranges[-1][1] == M
    for (a, b), (c, _) in zip(ranges, ranges[1:] + [(M, M)]):
        assert a < b <= M and b == c   # contiguous, each below M
        assert a % col_tile == 0
    ctas = -(-N // row_tile) * B * splits
    if kind == "prologue":
        assert splits == 1 and ctas >= t_asg.FILL_CTAS
    if kind in ("bootstrap", "reobs"):
        assert splits > 1 and ctas >= t_asg.FILL_CTAS >= 64
    if kind == "streams":
        assert ctas * splits >= t_asg.FILL_CTAS
    # no more splits than that needs
    assert splits == 1 or ctas // 2 < t_asg.FILL_CTAS


def _combine_lse(parts, tail=16):
    """(m, s) partials combined in order, `tail` at a time (as the
    kernel's combine_lse)."""
    m, s = parts[0][0].clone().fill_(-torch.inf), torch.zeros_like(parts[0][1])
    for k0 in range(0, len(parts), tail):
        chunk = parts[k0:k0 + tail]
        mc = torch.stack([m] + [q[0] for q in chunk]).amax(0)
        sc = torch.where(m > -torch.inf, s * torch.exp(m - mc), 0.0)
        for qm, qs in chunk:
            sc = sc + torch.where(qm > -torch.inf, qs * torch.exp(qm - mc),
                                  0.0)
        m, s = mc, sc
    return m, s


def _combine_best(parts, v, i):
    """(value, index) partials in order from (v, i): a strictly larger
    value wins."""
    for qv, qi in parts:
        take = qv > v
        v, i = torch.where(take, qv, v), torch.where(take, qi, i)
    return v, i


def _assign_kernel_order(f0, f1, c0, c1, m0, m1, scale, splits, row_tile=8,
                         warp_rows=4, col_tile=4):
    """csrc/assignment.cu's arithmetic in plain torch, for one pair, at
    small tiles: the columns cut into `splits` ranges of whole column tiles
    (ops/attention.split_ranges); rows carry an online (max, sum of exp)
    or (best, first index) over their split's column tiles in order, the
    splits then meet in split order; columns reduce over each warp's rows,
    then over the warps of a row tile, then over the row tiles in order from
    the TPU's carry (-1e9, 0). Masks act as min(logit, row fill, column
    fill) with fills +inf (valid), -1e9 (masked)."""
    N, M = f0.shape[0], f1.shape[0]
    sim = f0 @ f1.T
    inf = torch.tensor(torch.inf)
    rfill = torch.where(m0, inf, -1e9)[:, None]
    cfill = torch.where(m1, inf, -1e9)[None, :]
    ranges = t_attn.split_ranges(M, splits, col_tile)
    row_tiles = [(r, min(r + row_tile, N)) for r in range(0, N, row_tile)]

    def logits(mul):
        return torch.minimum(torch.minimum(sim * mul, cfill), rfill)

    def col_parts(obj, reduce):
        # per row tile: per warp of `warp_rows` rows, then over the warps
        out = []
        for a, b in row_tiles:
            warps = [reduce(obj[w:min(w + warp_rows, b)])
                     for w in range(a, b, warp_rows)]
            out.append(warps)
        return out

    # pass 1
    l1 = logits(scale)
    row_p = []
    for a, b in ranges:
        m = torch.full((N,), -torch.inf)
        s = torch.zeros(N)
        for j in range(a, b, col_tile):
            x = l1[:, j:min(j + col_tile, b)]
            mn = torch.maximum(m, x.amax(1))
            s = s * torch.exp(m - mn).nan_to_num(0.0) + torch.exp(
                x - mn[:, None]).sum(1)
            m = mn
        row_p.append((m, s))
    m, s = _combine_lse(row_p)
    lse_r = m + torch.log(s)

    def lse_part(x):
        mx = x.amax(0)
        return mx, torch.exp(x - mx).sum(0)

    tiles = [_combine_lse(w, tail=len(w)) for w in col_parts(l1, lse_part)]
    m, s = _combine_lse(tiles)
    lse_c = m + torch.log(torch.clamp_min(s, 1e-30))

    # pass 2
    l2 = logits(2 * scale)
    gr = l2 + torch.where(m1, c1 - lse_c, -1e9)[None, :]
    row_b = []
    for a, b in ranges:
        v, i = gr[:, a:b].max(1)        # the first index of the max
        row_b.append((v, i + a))
    v0, nn0 = _combine_best(row_b, torch.full((N,), -torch.inf),
                            torch.full((N,), 2 ** 31 - 1))
    gc = l2 + torch.where(m0, c0 - lse_r, -1e9)[:, None]
    row_starts = iter([a for a, b in row_tiles
                       for a in range(a, b, warp_rows)])

    def best_part(x):
        v, i = x.max(0)
        return v, i + next(row_starts)

    tiles = [_combine_best(w[1:], *w[0]) for w in col_parts(gc, best_part)]
    v1, nn1 = _combine_best(tiles, torch.full((M,), -1e9),
                            torch.zeros(M, dtype=torch.long))
    return nn0, v0, lse_r, nn1, v1, lse_c


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_assignment_kernel_order_matches_pallas_interpret(splits):
    """The kernel's tile and combine order against the JAX kernel, with
    ties, a fully masked row and column, a pair with one valid column and a
    pair with nothing valid."""
    rng = np.random.default_rng(9)
    B, N, M, Df = 3, 40, 36, 64
    f0, f1, z0, z1, m0, m1 = _asg_inputs(rng, B, N, M, Df)
    m0[1] = m1[1] = False            # nothing valid
    scale = 1.0 / np.sqrt(Df)
    c0 = np.asarray(jax.nn.log_sigmoid(z0))
    c1 = np.asarray(jax.nn.log_sigmoid(z1))
    for b in range(B):
        got = _assign_kernel_order(*(torch.tensor(a[b]) for a in
                                     (f0, f1, c0, c1, m0, m1)), scale,
                                   splits)
        ref = j_asg._fused_reductions(f0[b], f1[b], c0[b], c1[b], m0[b],
                                      m1[b], scale, 16, True)
        for name, g, r in zip(("nn0", "v0", "lse_r", "nn1", "v1", "lse_c"),
                              got, ref):
            if name.startswith("nn"):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                              err_msg=f"{name} pair {b}")
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           atol=TOL, rtol=TOL,
                                           err_msg=f"{name} pair {b}")
        if b == 0:
            assert int(got[0][1]) == 4 and int(got[3][11]) == 7   # ties
        if b == 1:
            assert not got[0].any() and not got[3].any()


def _nms_map(case):
    """(heat (B, H, W) float32 >= 0, radius)."""
    rng = np.random.default_rng(20)
    if case == "random":
        return rng.uniform(size=(2, 48, 64)).astype(np.float32), 2
    if case == "quantised with zeros":
        heat = np.round(rng.uniform(size=(2, 40, 72)), 1).astype(np.float32)
        heat[rng.uniform(size=heat.shape) < 0.4] = 0.0
        return heat, 3
    if case == "plateau":                  # tests/test_flags.py, 8 x 32
        heat = np.zeros((1, 32, 64), np.float32)
        heat[0, 8:16, 8:40] = 0.5
        return heat, 4
    if case == "border plateau":
        heat = np.round(rng.uniform(size=(2, 33, 65)), 1).astype(np.float32)
        heat[0, :6, :9] = 2.0              # top-left corner
        heat[0, 28:, 50:] = 2.0            # bottom-right corner
        heat[1, :, 64] = 3.0               # the last column
        heat[1, 0, :] = 3.0                # the first row
        return heat, 4
    raise ValueError(case)


NMS_CASES = ["random", "quantised with zeros", "plateau", "border plateau"]


@pytest.mark.parametrize("case", NMS_CASES)
def test_nms_plain_matches_pallas_interpret_and_xla(case):
    heat, r = _nms_map(case)
    got = t_nms.nms(torch.from_numpy(heat), r).numpy()
    # max is exact and the tie-break is on integers: exact equality. The
    # Pallas kernel pads with 0.0, the others with -inf; heat >= 0.
    np.testing.assert_array_equal(
        got, np.asarray(j_nms._nms_pallas(jnp.asarray(heat), r,
                                          interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(j_nms._nms_xla(jnp.asarray(heat), r)))
    assert (got > 0).sum() >= 1
    # survivors pairwise Chebyshev-separated by more than r
    for b in range(heat.shape[0]):
        yx = np.argwhere(got[b] > 0)
        d = np.abs(yx[:, None] - yx[None]).max(-1)
        assert (d[np.triu_indices(len(yx), 1)] > r).all()


@pytest.mark.parametrize("case", NMS_CASES)
def test_detect_keypoints_matches_jax_through_both_nms(case, monkeypatch):
    import functools
    heat, r = _nms_map(case)
    kt, st, vt = t_nms.detect_keypoints(torch.from_numpy(heat), 48, 0.05, r)
    ref_xla = j_nms.detect_keypoints(jnp.asarray(heat), 48, 0.05, r)
    # the reference's opt-in route, run as its own tests run the kernel here
    monkeypatch.setattr(j_nms, "_nms_pallas", functools.partial(
        j_nms._nms_pallas, interpret=True))
    ref_pl = j_nms.detect_keypoints(jnp.asarray(heat), 48, 0.05, r,
                                    use_pallas=True)
    for kj, sj, vj in (ref_xla, ref_pl):
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


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
    t_nms.detect_keypoints(torch.rand(1, 24, 32), 16, 0.1, 2)
    assert _build.LAUNCHES == {"attention": 0, "assignment": 0, "nms": 0,
                               "pose_lm": 0}


def test_cuda_wrappers_reject_cpu_tensors():
    q = torch.zeros(2, 8, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        t_attn.attention_cuda(q, q, q, torch.ones(8, dtype=torch.bool), 0.1)
    f = torch.zeros(8, 64, dtype=torch.bfloat16)
    c = torch.zeros(8)
    m = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        t_asg.fused_reductions_cuda(f, f, c, c, m, m, 0.1)
    with pytest.raises(ValueError):
        t_nms.nms_cuda(torch.zeros(1, 8, 8), 2)
