"""The plain reference against the port's plain path, on the tiny
checkpoints at a tiny size, in float32 on the CPU. (The test imports the
port; the reference does not.)"""

import os

import numpy as np
import pytest
import torch

from benchmark.reference import frontend as ref_fe
from benchmark.reference import nets

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CKPT = os.path.join(ROOT, "checkpoints")
CPU = torch.device("cpu")
H, W = 64, 104


@pytest.fixture(scope="module")
def port():
    from gl_slam_tpu_torch.train import e2e
    sp, lg = e2e.load_tiny_frontend(CKPT, device="cpu", dtype=torch.float32)
    head = e2e.load_tiny_subpix(CKPT, pair=True, device="cpu",
                                dtype=torch.float32)
    return sp, lg, head


@pytest.fixture(scope="module")
def weights():
    return {k: nets.load_npz(os.path.join(CKPT, f"{k}_tiny.npz"), CPU)
            for k in ("sp", "lg", "kspair")}


def images(n=2, seed=0):
    from benchmark import scene
    sc = scene.loop_scene(seed, 30, 40, H, W)
    return torch.from_numpy(np.stack([scene.render_frame(sc, i, 96)
                                      for i in range(n)]))


def test_superpoint(port, weights):
    x = images()
    heat, grid = nets.superpoint(weights["sp"], x, nets.Ops())
    h2, g2 = port[0](x[..., None])
    torch.testing.assert_close(heat, h2, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(grid, g2, rtol=1e-5, atol=1e-5)


def test_lightglue_and_assignment(port, weights):
    from gl_slam_tpu_torch.models import lightglue as port_lg
    g = torch.Generator().manual_seed(1)
    n, m, D = 48, 40, 64
    d0 = torch.nn.functional.normalize(torch.randn(n, D, generator=g), dim=-1)
    d1 = torch.nn.functional.normalize(torch.randn(m, D, generator=g), dim=-1)
    k0 = torch.rand(n, 2, generator=g) * 2 - 1
    k1 = torch.rand(m, 2, generator=g) * 2 - 1
    m0 = torch.rand(n, generator=g) > 0.2
    m1 = torch.rand(m, generator=g) > 0.2
    got = nets.lightglue(weights["lg"], d0, d1, k0, k1, m0, m1, 2, nets.Ops())
    want = port[1](d0, d1, k0, k1, m0, m1, return_features=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b.float(), rtol=1e-4, atol=1e-5)
    sim = got[0] @ got[1].T / 64 ** 0.5
    ref = port_lg.assignment(sim, got[2], got[3], m0, m1, 0.0)
    m_got, s_got = nets.assignment(*got, m0, m1, 0.0)
    assert torch.equal(m_got, ref.matches0.long())
    torch.testing.assert_close(s_got, ref.mscores0, rtol=1e-5, atol=1e-7)


def test_pair_head(port, weights):
    g = torch.Generator().manual_seed(2)
    p0, p1 = torch.rand(2, 30, 7, 7, generator=g)
    d0, d1 = torch.randn(2, 30, 64, generator=g)
    s = torch.rand(30, generator=g)
    got = nets.pair_head(weights["kspair"], p0, p1, d0, d1, s, nets.Ops(), 1.5)
    torch.testing.assert_close(got, port[2](p0, p1, d0, d1, s), rtol=1e-5,
                               atol=1e-6)


def test_front_end_and_pair_refinement(port, weights):
    """The reference's extraction equals the port's extract function, and
    its pair refinement the port's prologue refinement, on the same
    images."""
    from gl_slam_tpu_torch.config import micro_config
    from gl_slam_tpu_torch.models.lightglue import normalize_keypoints
    from gl_slam_tpu_torch.models.subpix import pair_refine_scatter
    from gl_slam_tpu_torch.ops import assignment as port_asg
    from gl_slam_tpu_torch.slam import fused
    cfg = micro_config(H, W, 96, 64)
    fe = cfg.frontend
    spec = dict(image_height=H, image_width=W, max_keypoints=96,
                score_threshold=fe.score_threshold, nms_radius=fe.nms_radius,
                subpix_patch=fe.subpix_patch, stem_stride=2,
                match_threshold=fe.match_threshold, lightglue_heads=2,
                offset_range=1.5)
    x = images(2, seed=3)
    sp, lg, head = port
    kp, desc, valid, patches = fused.build_extract_fn(cfg, sp, head)(x)
    ref = ref_fe.extract(weights["sp"], x, spec, nets.Ops(), 7)
    assert valid.sum() > 40
    assert torch.equal(valid, ref.valid)
    torch.testing.assert_close(kp, ref.kpts, rtol=0, atol=1e-5)
    torch.testing.assert_close(desc, ref.desc, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(patches, ref.patches)
    # the prologue's refinement of frame 1 against frame 0
    f0, f1, z0, z1 = lg(desc[0], desc[1], normalize_keypoints(kp[0], H, W),
                        normalize_keypoints(kp[1], H, W), valid[0], valid[1],
                        return_features=True)
    mo = port_asg.fused_assignment(f0, f1, z0, z1, valid[0], valid[1],
                                   1 / 8.0, 0.0)
    keep = (mo.matches0 >= 0) & (mo.mscores0 > fe.match_threshold)
    want = pair_refine_scatter(head, patches[0], patches[1], desc[0],
                               desc[1], kp[1], mo.matches0, mo.mscores0,
                               keep)
    a = ref_fe.Features(*(t[0:1] for t in ref))
    b = ref_fe.Features(*(t[1:2] for t in ref))
    got, refined = ref_fe.refine_pair(weights["lg"], weights["kspair"], a, b,
                                      0, spec, nets.Ops())
    assert int(refined.sum()) == int(keep.sum()) > 5
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_fp8_rounds_every_product(weights):
    """The control: the same forward with fp8-rounded operands departs
    from float32 by far more than float32 rounding."""
    x = images(1)
    h32, g32 = nets.superpoint(weights["sp"], x, nets.Ops())
    h8, g8 = nets.superpoint(weights["sp"], x, nets.Ops(fp8=True))
    gap = 1 - (g32 * g8).sum(-1)
    assert float(gap.max()) > 1e-4
    q = nets.q8(torch.tensor([1.0, 0.3, -448.0]))
    assert float(q[2]) == -448.0 and abs(float(q[1]) - 0.3) < 0.02
