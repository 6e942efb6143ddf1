"""The host side of the pose-only LM kernel (slam/pose_ba.pose_lm_layout):
how the arguments of `pose_only_ba_multi` are laid out for csrc/pose_lm.cu,
the arguments it refuses, and that CPU tensors keep the plain path. The
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from gl_slam_tpu_torch.ops import _build
from gl_slam_tpu_torch.slam import pose_ba


def _problem(lead_pts, starts, N=40, per_stream_k=False, seed=0):
    """Posed problems of the tracker's layout: points (*lead_pts, N, 3)
    seen at uv from a pose near the starts (*lead_pts, [starts,] 3, 3),
    with 0.5 px noise and a few 30 px outliers."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa
    pts = f(*lead_pts, N, 3) * torch.tensor([4.0, 3.0, 2.0]) \
        + torch.tensor([0.0, 0.0, 10.0])
    K = torch.tensor([[400.0, 0.0, 320.0], [0.0, 410.0, 240.0],
                      [0.0, 0.0, 1.0]])
    if per_stream_k:
        K = K.expand(*lead_pts, 3, 3) * (1.0 + 0.01 * torch.arange(
            int(np.prod(lead_pts)), dtype=torch.float32).reshape(
                *lead_pts, 1, 1))
        K[..., 2, 2] = 1.0
    t_true = 0.2 * f(*lead_pts, 3)
    pc = pts + t_true[..., None, :]
    uv = (pc @ K.transpose(-1, -2))[..., :2] / pc[..., 2:3]
    uv = uv + 0.5 * f(*lead_pts, N, 2)
    uv[..., :4, :] += 30.0
    R_lead = lead_pts + ((starts,) if starts else ())
    w = 0.02 * f(*R_lead, 3)
    W = torch.zeros(*R_lead, 3, 3)
    W[..., 0, 1], W[..., 0, 2], W[..., 1, 2] = -w[..., 2], w[..., 1], \
        -w[..., 0]
    R0 = torch.matrix_exp(W - W.transpose(-1, -2))
    tt = t_true if not starts else t_true[..., None, :]
    t0 = (tt + 0.05 * f(*R_lead, 3)).contiguous()
    mask = torch.from_numpy(rng.uniform(size=(*lead_pts, N)) < 0.8)
    pw = torch.from_numpy(np.where(rng.uniform(size=(*lead_pts, N)) < 0.3,
                                   0.2, 1.0).astype(np.float32))
    return K, R0, t0, pts, uv, mask, pw


# (points' leading shape, starts per row, per-stream K): one start; three
# starts over one point set; a stream axis with one start a stream (the
# gate refine) and three (the tracker's start axis), K shared and per
# stream; two leading axes of streams.
LAYOUTS = [((), 0, False), ((), 3, False), ((4,), 0, False),
           ((4,), 3, False), ((4,), 0, True), ((4,), 3, True),
           ((2, 3), 2, True)]


@pytest.mark.parametrize("lead_pts,starts,per_k", LAYOUTS)
def test_layout_maps_each_problem_to_its_rows(lead_pts, starts, per_k):
    K, R0, t0, pts, uv, mask, pw = _problem(lead_pts, starts,
                                            per_stream_k=per_k)
    a = pose_ba.pose_lm_layout(K, R0, t0, pts, uv, mask, pw)
    B = int(np.prod(lead_pts))
    per = max(starts, 1)
    assert a.lead == tuple(R0.shape[:-2]) and a.per == per
    assert a.R.shape == (B * per, 3, 3) and a.t.shape == (B * per, 3)
    assert a.pts.shape == (B, 40, 3) and a.uv.shape == (B, 40, 2)
    assert a.mask.shape == (B, 40) and a.mask.dtype == torch.bool
    assert a.pw.shape == (B, 40)
    assert a.K.shape == ((B, 3, 3) if per_k else (1, 3, 3))
    for x in (a.K, a.R, a.t, a.pts, a.uv, a.mask, a.pw):
        assert x.is_contiguous()
    # Problem p, solved alone on its row by the plain version, is the
    # batched plain result's problem p: the layout reads the rows the plain
    # version broadcasts. Alone and batched, the CPU's products sum in
    # other orders, and the stall rule stops on a flat minimum at another
    # iterate: measured over these layouts at most 1.0e-5 apart in R,
    # 1.1e-4 in t and 9e-6 relative in the cost, where another row's
    # solution lies ~0.2 away in t.
    kw = dict(iters=4, coarse_iters=2)
    whole = pose_ba.pose_only_ba_multi_plain(K, R0, t0, pts, uv, mask,
                                             point_weights=pw, **kw)
    for p in (0, B * per - 1):
        b = p // per
        one = pose_ba.pose_only_ba_multi_plain(
            a.K[b if per_k else 0], a.R[p], a.t[p], a.pts[b], a.uv[b],
            a.mask[b], point_weights=a.pw[b], **kw)
        torch.testing.assert_close(one.R, whole.R.reshape(-1, 3, 3)[p],
                                   atol=5e-5, rtol=0)
        torch.testing.assert_close(one.t, whole.t.reshape(-1, 3)[p],
                                   atol=5e-4, rtol=0)
        torch.testing.assert_close(one.final_cost,
                                   whole.final_cost.reshape(-1)[p],
                                   atol=0, rtol=5e-5)
        assert int(one.num_used) == int(whole.num_used.reshape(-1)[p]) \
            == int(a.mask[b].sum())


def test_layout_converts_and_copies_only_what_it_must():
    """Float arguments of another type become float32; contiguous float32
    ones pass as views; a transposed one is made contiguous."""
    K, R0, t0, pts, uv, mask, _ = _problem((4,), 3)
    a = pose_ba.pose_lm_layout(K.double(), R0, t0, pts, uv.double(), mask)
    assert a.K.dtype == a.uv.dtype == torch.float32 and a.pw is None
    assert a.pts.data_ptr() == pts.data_ptr()
    assert a.R.data_ptr() == R0.data_ptr()
    pts_t = pts.transpose(0, 1).contiguous().transpose(0, 1)
    b = pose_ba.pose_lm_layout(K, R0, t0, pts_t, uv, mask)
    assert b.pts.is_contiguous() and torch.equal(b.pts, a.pts)


def _bad(case):
    K, R0, t0, pts, uv, mask, pw = _problem((4,), 3)
    args = dict(K=K, R0s=R0, t0s=t0, pts_w=pts, uv=uv, mask=mask,
                point_weights=pw)
    args.update({
        "R not 3x3": dict(R0s=R0[..., :2]),
        "t off R": dict(t0s=t0[:, :2]),
        "points not a prefix": dict(pts_w=pts[:3]),
        "points past the starts": dict(pts_w=pts.expand(2, 4, 40, 3)),
        "uv": dict(uv=uv[:, :39]),
        "mask": dict(mask=mask[:, :39]),
        "weights": dict(point_weights=pw[:2]),
        "K rows": dict(K=K.expand(3, 3, 3)),
        "mask not bool": dict(mask=mask.float()),
        "devices": dict(uv=uv.to("meta")),
    }[case])
    return args


@pytest.mark.parametrize("case", [
    "R not 3x3", "t off R", "points not a prefix", "points past the starts",
    "uv", "mask", "weights", "K rows", "mask not bool", "devices"])
def test_layout_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError, match="pose_lm"):
        pose_ba.pose_lm_layout(**_bad(case))


def test_cuda_wrapper_refuses_cpu_tensors():
    K, R0, t0, pts, uv, mask, pw = _problem((4,), 3)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        pose_ba.pose_lm_cuda(K, R0, t0, pts, uv, mask, point_weights=pw)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("lead_pts,starts,per_k", LAYOUTS[:4])
def test_cpu_tensors_take_the_plain_path(lead_pts, starts, per_k):
    """pose_only_ba_multi on the CPU is the plain version bit for bit, and
    counts no launch."""
    K, R0, t0, pts, uv, mask, pw = _problem(lead_pts, starts,
                                            per_stream_k=per_k, seed=3)
    kw = dict(iters=6, coarse_iters=3, point_weights=pw)
    before = dict(_build.LAUNCHES)
    got = pose_ba.pose_only_ba_multi(K, R0, t0, pts, uv, mask, **kw)
    want = pose_ba.pose_only_ba_multi_plain(K, R0, t0, pts, uv, mask, **kw)
    assert dict(_build.LAUNCHES) == before
    assert "pose_lm" in before
    for x, y in zip(got, want):
        assert torch.equal(x, y)
