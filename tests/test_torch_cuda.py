"""The CUDA kernels against their plain PyTorch versions, and a short run
of the tracker with its backend, on the card.

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
from gl_slam_tpu_torch.ops import nms as t_nms

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# (lead, Nq, Nk, dh, empty first split): ragged shapes; the four
# re-observation shapes, which the kernel splits over 2-4 CTAs; a mask that
# empties the first split with Nk not a multiple of S x the key tile;
# Nq < 64 split 8 ways; the loop detector's four shapes (2 candidates x 2
# heads, a 256-row keyframe database against a 2048-keypoint frame), with
# the first candidate's keys all masked; the batched re-observation mode's
# (the window and covisibility sets of 1024 points on a leading axis of 2
# against the 2048-keypoint frame, whose self-attention is the (2,) 2048 x
# 2048 case above); the multi-stream chunk's at 4 streams (the prologue's
# 4 x 8 pairs x 2 sets, the re-observation shapes with 4 and 16 streams in
# front).
ATTN_CASES = [((3,), 100, 70, 128, False), ((), 64, 200, 64, False),
              ((2, 2), 17, 9, 32, False),
              ((), 1024, 1024, 128, False), ((), 2048, 2048, 128, False),
              ((), 1024, 2048, 128, False), ((), 2048, 1024, 128, False),
              ((), 1024, 1000, 128, True), ((), 40, 900, 128, False),
              ((2,), 256, 256, 128, False), ((2,), 2048, 2048, 128, False),
              ((2,), 256, 2048, 128, False), ((2,), 2048, 256, 128, False),
              ((2,), 1024, 1024, 128, False), ((2,), 1024, 2048, 128, False),
              ((2,), 2048, 1024, 128, False),
              ((4, 8, 2), 2048, 2048, 128, False),
              ((4,), 1024, 1024, 128, False), ((4,), 2048, 2048, 128, False),
              ((4,), 1024, 2048, 128, False), ((4,), 2048, 1024, 128, False),
              ((16,), 1024, 2048, 128, False),
              ((16,), 2048, 1024, 128, False)]


@pytest.mark.parametrize("lead,Nq,Nk,dh,masked", ATTN_CASES)
def test_attention_kernel_matches_plain(cuda_device, lead, Nq, Nk, dh,
                                        masked):
    """One launch per call, every element within attention_tolerance."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(*lead, 2, n, dh, generator=g, device=cuda_device)
               .to(torch.bfloat16) for n in (Nq, Nk, Nk))
    mask = torch.rand(*lead, Nk, generator=g, device=cuda_device) < 0.6
    _, key_tile, splits = t_attn.split_plan(q.numel() // (Nq * dh), Nq, Nk)
    if masked:
        assert splits > 1 and Nk % (key_tile * splits)
        mask[..., :t_attn.split_ranges(Nk, splits, key_tile)[0][1]] = False
    else:
        mask.view(-1, Nk)[0] = False       # a set with every key masked
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
    # Row 1 prefers columns 4 = 9 = 12 (duplicates), column 11 rows 7 = 15
    # = 20: ties within a thread's columns and rows, across threads and
    # across warps of the kernel.
    f1[0, 4] = f1[0, 9] = f1[0, 12] = f0[0, 1] * 4
    z1[0, 4] = z1[0, 9] = z1[0, 12] = 5.0
    f0[0, 7] = f0[0, 15] = f0[0, 20] = f1[0, 11] * 4
    z0[0, 7] = z0[0, 15] = z0[0, 20] = 5.0
    m0[0, [1, 7, 15, 20]] = True
    m1[0, [4, 9, 11, 12]] = True
    return f0, f1, z0, z1, m0, m1


# (B, N, M, Df): the three path shapes (chunk prologue, bootstrap,
# re-observation; the last two split their columns over 4 and 8 CTAs), the
# batched re-observation mode's two (the 1024-point sets on a leading axis
# of 2, and 2048-point sets), N and M that are multiples of no tile (split
# and unsplit), each feature dim; the last pair of every B > 1 case has
# every row and column masked.
ASG_CASES = [(8, 2048, 2048, 256), (1, 2048, 2048, 256),
             (1, 1024, 2048, 256), (2, 1024, 2048, 256),
             (2, 2048, 2048, 256), (2, 130, 90, 256), (1, 64, 300, 128),
             (3, 1000, 777, 64), (1, 200, 1000, 128), (1, 40, 65, 256),
             # the multi-stream chunk's: 4 streams x 8 prologue pairs, 4
             # and 16 re-observation sets
             (32, 2048, 2048, 256), (4, 1024, 2048, 256),
             (16, 1024, 2048, 256)]


@pytest.mark.parametrize("B,N,M,Df", ASG_CASES)
def test_assignment_kernel_matches_plain(cuda_device, B, N, M, Df):
    arrs = _asg_inputs(np.random.default_rng(5), B, N, M, Df)
    f0, f1, z0, z1, m0, m1 = (torch.from_numpy(a).to(cuda_device)
                              for a in arrs)
    if B > 1:
        m0[-1] = m1[-1] = False            # a pair with nothing valid
    f0, f1 = f0.to(torch.bfloat16), f1.to(torch.bfloat16)
    c0 = torch.nn.functional.logsigmoid(z0)
    c1 = torch.nn.functional.logsigmoid(z1)
    before = _build.LAUNCHES["assignment"]
    got = t_asg.fused_reductions(f0, f1, c0, c1, m0, m1, Df ** -0.5)
    assert _build.LAUNCHES["assignment"] == before + 2   # kernels per call
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
    if B > 1:
        # nothing valid: every objective ties, so index 0 everywhere, and
        # each column keeps the TPU's starting carry (-1e9, 0)
        for g_, r_ in zip(got, ref):
            assert torch.equal(g_[-1], r_[-1])
        assert not bool(got[0][-1].any()) and not bool(got[3][-1].any())


def test_assignment_kernel_at_the_detector_shape(cuda_device):
    """2 candidates x 256 database rows against 2048 keypoints: ragged
    database masks, and a candidate whose database is empty (a keyframe
    with no 3-D points, or a missing candidate) against a valid frame."""
    arrs = _asg_inputs(np.random.default_rng(6), 2, 256, 2048, 256)
    f0, f1, z0, z1, m0, m1 = (torch.from_numpy(a).to(cuda_device)
                              for a in arrs)
    m0[1] = False
    f0, f1 = f0.to(torch.bfloat16), f1.to(torch.bfloat16)
    c0 = torch.nn.functional.logsigmoid(z0)
    c1 = torch.nn.functional.logsigmoid(z1)
    got = t_asg.fused_reductions(f0, f1, c0, c1, m0, m1, 256 ** -0.5)
    ref = t_asg.fused_reductions_plain(f0, f1, c0, c1, m0, m1, 256 ** -0.5)
    for name, g_, r_ in zip(("nn0", "v0", "lse_r", "nn1", "v1", "lse_c"),
                            got, ref):
        if name.startswith("nn"):
            assert float((g_[0] != r_[0]).float().mean()) < 0.01, name
        else:
            assert float((g_ - r_).abs().max()) <= 1e-3, name
    # the empty database: every entry of that pair masked, as in the plain
    # version (index 0, the starting carry)
    for g_, r_ in zip(got, ref):
        assert torch.equal(g_[1], r_[1])
    # and the assignment through the kernel equals the plain one there: no
    # database row matches (the detector reads matches0 only; matches1 may
    # pair a frame column with a masked row, as in the plain version)
    mo = t_asg.fused_assignment(f0, f1, z0, z1, m0, m1, 256 ** -0.5)
    mp = t_asg.fused_assignment(*(x.cpu() for x in (f0, f1, z0, z1, m0,
                                                     m1)), 256 ** -0.5)
    assert not bool((mo.matches0[1] >= 0).any())
    assert torch.equal(mo.matches0[1].cpu(), mp.matches0[1])
    assert torch.equal(mo.matches1[1].cpu(), mp.matches1[1])


@pytest.mark.parametrize("B,N,M", [(1, 1024, 2048), (8, 2048, 2048),
                                   (2, 300, 700)])
def test_assignment_kernel_gives_the_same_bits_twice(cuda_device, B, N, M):
    """The partials meet in a fixed order whichever CTA finishes last, so
    two calls on the same inputs agree bit for bit."""
    arrs = _asg_inputs(np.random.default_rng(8), B, N, M, 256)
    f0, f1, z0, z1, m0, m1 = (torch.from_numpy(a).to(cuda_device)
                              for a in arrs)
    f0, f1 = f0.to(torch.bfloat16), f1.to(torch.bfloat16)
    c0 = torch.nn.functional.logsigmoid(z0)
    c1 = torch.nn.functional.logsigmoid(z1)
    first = t_asg.fused_reductions(f0, f1, c0, c1, m0, m1, 0.0625)
    for _ in range(3):
        again = t_asg.fused_reductions(f0, f1, c0, c1, m0, m1, 0.0625)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def _nms_maps(rng, B, H, W, r, seg_rows=0):
    """Quantised random maps (ties everywhere) with exact zeros, plateaus at
    the image border, and at every border of the kernel's plan (column
    strips, row segments, the 4-column lanes around them): plateaus across
    each strip and segment corner, and equal isolated maxima r columns or r
    rows apart across those borders (the later one must go)."""
    heat = np.round(rng.uniform(size=(B, H, W)), 2).astype(np.float32)
    heat[rng.uniform(size=heat.shape) < 0.3] = 0.0
    heat[0, :5, :7] = 0.99                  # image corner
    heat[-1, H - 3:, W - 40:] = 0.98        # bottom border
    heat[-1, H // 2, :] = 0.96              # a full row
    plan = t_nms.nms_plan(B, H, W, r, seg_rows)
    xs = range(plan["strip_cols"], W, plan["strip_cols"])
    ys = range(plan["seg_rows"], H, plan["seg_rows"])
    for b in range(B):
        for x in xs:
            heat[b, :, x - 1:x + 1] = np.minimum(heat[b, :, x - 1:x + 1],
                                                 0.5)
            heat[b, 2, x - 1] = heat[b, 2, min(x - 1 + r, W - 1)] = 0.995
            for y in ys:
                heat[b, y - 2:y + 2, x - 3:x + 3] = 0.97   # across a corner
        for y in ys:
            heat[b, y - 1, 5] = heat[b, min(y - 1 + r, H - 1), 5 + r // 2] = \
                0.993
    return heat


# (B, H, W, r, seg_rows): the path shapes (8 and 2 maps of 376 x 1248 at
# r 4, the default plan); widths that are not multiples of 4 (131, 1241)
# or of 32; maps shorter than one segment; segments of 1, 5 and 16 rows;
# r 0, 1, 3, 4, 16; B 1.
NMS_CASES = [(8, 376, 1248, 4, 0), (2, 376, 1248, 4, 0),
             (16, 376, 1248, 4, 0),        # extraction in groups of 2 streams
             (1, 376, 1241, 4, 0), (3, 70, 131, 3, 0), (1, 33, 64, 1, 0),
             (2, 40, 40, 0, 0), (1, 97, 200, 16, 0), (1, 9, 131, 4, 0),
             (2, 12, 1248, 3, 0), (1, 60, 260, 4, 1), (2, 80, 1241, 4, 5),
             (1, 100, 300, 16, 16), (1, 50, 96, 0, 7)]


@pytest.mark.parametrize("B,H,W,r,seg_rows", NMS_CASES)
def test_nms_kernel_equals_plain(cuda_device, B, H, W, r, seg_rows):
    heat = torch.from_numpy(_nms_maps(np.random.default_rng(7), B, H, W, r,
                                      seg_rows)).to(cuda_device)
    before = _build.LAUNCHES["nms"]
    got = t_nms.nms_cuda(heat, r, seg_rows=seg_rows)
    assert _build.LAUNCHES["nms"] == before + 1
    # max and comparisons are exact: no tolerance
    assert torch.equal(got, t_nms.nms_plain(heat, r))
    # detection through the kernel, and through the plain version on the CPU
    got = t_nms.detect_keypoints(heat, 256, 0.05, r)
    want = t_nms.detect_keypoints(heat.cpu(), 256, 0.05, r)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("H,W,r", [(376, 1248, 3), (376, 1241, 4),
                                   (480, 752, 4)])
def test_nms_kernel_at_the_per_frame_shapes(cuda_device, H, W, r):
    """Batch 1, as the per-frame route extracts: the learned detector's
    padded map at the command line's radius 3, and Harris at radius 4 on
    the KITTI and EuRoC frame sizes. A map with plateaus on the plan's
    borders and the Harris response of a rendered frame (border rows and
    columns zeroed as HarrisExtractor does) each equal the plain version
    bit for bit, and so do the keypoints detected through them."""
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.models import classical

    scene = synthetic.make_scene(num_landmarks=4000, num_frames=2, height=H,
                                 width=W, seed=5)
    img = torch.from_numpy(synthetic.render_frame(scene, 1, 2048))
    resp = classical.harris_response(img.to(cuda_device))
    resp[:8], resp[H - 8:], resp[:, :8], resp[:, W - 8:] = 0, 0, 0, 0
    maps = [torch.from_numpy(_nms_maps(np.random.default_rng(11), 1, H, W,
                                       r)).to(cuda_device),
            resp[None].contiguous()]
    for heat in maps:
        got = t_nms.nms_cuda(heat, r)
        assert torch.equal(got, t_nms.nms_plain(heat, r))
        assert int((got > 1e-6).sum()) > 500
        got = t_nms.detect_keypoints(heat, 2048, 1e-6, r)
        want = t_nms.detect_keypoints(heat.cpu(), 2048, 1e-6, r)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("W", [1248, 1241])
def test_nms_kernel_on_an_unaligned_map(cuda_device, W):
    """A map whose rows do not start on 16-byte boundaries (a contiguous
    view at an odd offset) takes the kernel's scalar loads and stores."""
    heat = _nms_maps(np.random.default_rng(3), 2, 50, W, 4)
    buf = torch.zeros(heat.size + 1, device=cuda_device)
    view = buf[1:].view(heat.shape)
    view.copy_(torch.from_numpy(heat))
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert torch.equal(t_nms.nms(view, 4), t_nms.nms_plain(view, 4))


def test_short_ba_run_on_the_card(cuda_device):
    """The tiny pipeline with a BA pass every chunk, on the card: extraction
    through the NMS kernel, two BA passes, no rollback; then one BA pass on
    the final map on the card against the same pass on the CPU."""
    import dataclasses
    import os

    from gl_slam_tpu_torch import config as t_cfg
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.slam import ba as t_ba
    from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline
    from gl_slam_tpu_torch.train import e2e

    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
    H, W, N, D = 240, 320, 128, t_cfg.TINY_DESC_DIM
    cfg = t_cfg.micro_config(H, W, N, D)
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                  loop_closing=False))
    scene = synthetic.make_scene(num_landmarks=900, num_frames=12, height=H,
                                 width=W, desc_dim=D, seed=11)
    stack = e2e.render_stack(scene, 12, N)
    # bfloat16 networks: the attention kernel takes nothing else
    sp, lg = e2e.load_tiny_frontend(ckpt, device=cuda_device)
    pipe = ChunkedPipeline(cfg, scene.K, sp, lg, chunk=5, ba_every=5,
                           device=cuda_device)
    c = [-scene.poses_R[i].T @ scene.poses_t[i] for i in (0, 1)]
    before = _build.LAUNCHES["nms"]
    pipe.bootstrap_from_images(stack[0], stack[1],
                               float(np.linalg.norm(c[1] - c[0])))
    pipe.track_chunk(stack[2:7])
    pipe.track_chunk(stack[7:12])
    pipe.finish()
    assert _build.LAUNCHES["nms"] == before + 3     # one per extraction
    assert pipe.num_ba_runs == 2 and pipe.num_recoveries == 0
    R, t, fidx = pipe.trajectory()
    assert list(fidx) == list(range(12))
    assert np.isfinite(R).all() and np.isfinite(t).all()
    c_est = np.einsum('kij,kj->ki', R.transpose(0, 2, 1), -t)
    c_gt = np.stack([-scene.poses_R[i].T @ scene.poses_t[i] for i in fidx])
    assert float(np.sqrt(((c_est - c_gt) ** 2).sum(1).mean())) < 1.0

    m = pipe.state.map
    K = pipe.K
    on_card = t_ba.ba_step(cfg, K, m, 2, 10)
    on_cpu = t_ba.ba_step(cfg, K.cpu(), type(m)(*(x.cpu() for x in m)), 2, 10)
    # float32 in other summation orders (see tests/test_torch_backend.py)
    assert float((on_card.kf_R.cpu() - on_cpu.kf_R).abs().max()) < 1e-4
    assert float((on_card.kf_t.cpu() - on_cpu.kf_t).abs().max()) < 1e-3
    dist = on_cpu.pts_xyz.norm(dim=1, keepdim=True) + 1.0
    assert float(((on_card.pts_xyz.cpu() - on_cpu.pts_xyz).abs()
                  / dist).max()) < 1e-2
    assert int((on_card.pts_bad.cpu() != on_cpu.pts_bad).sum()) <= 3


def test_pair_mode_run_on_the_card(cuda_device):
    """The tiny pipeline in pair mode on the card through run_learned_e2e:
    the pair sub-pixel head (bfloat16, kspair_tiny.npz) in every chunk
    prologue, extraction through the NMS kernel, a BA pass per chunk."""
    import dataclasses
    import os

    from gl_slam_tpu_torch import config as t_cfg
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.train import e2e

    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
    H, W, N, D = 240, 320, 128, t_cfg.TINY_DESC_DIM
    cfg = t_cfg.micro_config(H, W, N, D)
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                  loop_closing=False))
    scene = synthetic.make_scene(num_landmarks=900, num_frames=12, height=H,
                                 width=W, desc_dim=D, seed=11)
    sp, lg = e2e.load_tiny_frontend(ckpt, device=cuda_device)
    head = e2e.load_tiny_subpix(ckpt, pair=True, device=cuda_device)
    before = _build.LAUNCHES["nms"]
    diag = {}
    res = e2e.run_learned_e2e(sp, lg, scene, cfg, 12, chunk=5, ba_every=5,
                              device=cuda_device,
                              stack=e2e.render_stack(scene, 12, N),
                              diag_out=diag, subpix=head)
    assert _build.LAUNCHES["nms"] == before + 3     # one per extraction
    assert res.num_keyframes == 12 and res.num_rejected == 0
    assert res.num_ba_runs == 2 and diag["num_recoveries"] == 0
    assert np.isfinite(diag["R"]).all() and np.isfinite(diag["t"]).all()
    assert res.mean_matches > 50 and res.ate_m < 1.0, res
    patches = diag["state"].prev_patches
    assert patches.is_cuda and patches.shape == (N, 7, 7)


def test_single_mode_run_on_the_card_like_the_cpu(cuda_device):
    """The tiny pipeline with the single-view head (bfloat16, ks_tiny.npz)
    refining every detection, on the card and on the CPU with the same
    RANSAC draws, each held to the bounds of
    test_pair_mode_run_on_the_card."""
    import dataclasses
    import os

    from gl_slam_tpu_torch import config as t_cfg
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.models.subpix import SubpixHead
    from gl_slam_tpu_torch.train import e2e

    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
    H, W, N, D = 240, 320, 128, t_cfg.TINY_DESC_DIM
    cfg = t_cfg.micro_config(H, W, N, D)
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                  loop_closing=False))
    scene = synthetic.make_scene(num_landmarks=900, num_frames=12, height=H,
                                 width=W, desc_dim=D, seed=11)
    stack = e2e.render_stack(scene, 12, N)
    hyp = cfg.geometry.essential_hypotheses
    draws = np.random.default_rng(0).random((11, hyp, 8)).astype(np.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        sp, lg = e2e.load_tiny_frontend(ckpt, device=dev)
        head = e2e.load_tiny_subpix(ckpt, device=dev)
        assert isinstance(head, SubpixHead)
        pos = [0]

        def feed(n):
            pos[0] += n
            return torch.from_numpy(draws[pos[0] - n:pos[0]])

        before = _build.LAUNCHES["nms"]
        diag = {}
        res = e2e.run_learned_e2e(sp, lg, scene, cfg, 12, chunk=5,
                                  ba_every=5, device=dev, stack=stack,
                                  diag_out=diag, subpix=head, draws=feed)
        launched = _build.LAUNCHES["nms"] - before
        assert launched == (3 if dev.type == "cuda" else 0)
        assert res.num_keyframes == 12 and res.num_rejected == 0, res
        assert res.num_ba_runs == 2 and diag["num_recoveries"] == 0
        assert np.isfinite(diag["R"]).all() and np.isfinite(diag["t"]).all()
        assert res.mean_matches > 50 and res.ate_m < 1.0, res
        assert diag["state"].prev_patches is None
        out[dev.type] = res
    print(f"single mode: card {out['cuda']}, cpu {out['cpu']}")


def test_cli_chunk_loop_does_not_wait_for_the_card(cuda_device, tmp_path,
                                                  capsys):
    """The command line on the card (tiny preset, single-view head, a
    KITTI layout with a padded tail chunk): every `track_chunk` after the
    warm-up, uploads of the frames and the gate included, runs under
    PyTorch's sync debug mode, which raises on an operation that makes the
    host wait for the stream."""
    import json
    import os

    from gl_slam_tpu_torch import cli
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.io.kitti import write_kitti_sequence
    from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline

    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
    scene = synthetic.make_scene(num_landmarks=700, num_frames=15,
                                 height=160, width=240, desc_dim=64, seed=23)
    root = write_kitti_sequence(str(tmp_path / "kitti"), scene, 15,
                                max_keypoints=96)
    track = ChunkedPipeline.track_chunk
    calls = []

    def strict(self, *args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = track(self, *args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(kw.get("frame_gate") is not None)
        return out

    ChunkedPipeline.track_chunk = strict
    try:
        rc = cli.main(["run", "--dataset", root, "--frontend", "superpoint",
                       "--preset", "tiny", "--subpix", "single",
                       "--weights", ckpt, "--out", str(tmp_path / "out"),
                       "--first-frame", "0", "--last-frame", "14",
                       "--height", "160", "--width", "240", "--kpts", "96",
                       "--chunk", "4", "--ba-every", "4"])
    finally:
        ChunkedPipeline.track_chunk = track
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert calls == [False, False, False, True]   # 3 chunks and the tail
    assert report["frames_fed"] == 15 and report["frames_rejected"] >= 3
    assert report["frames_tracked"] >= 11 and report["ba_runs"] == 4


@pytest.mark.parametrize("route", [
    ("--dataset", "synthetic", "--frontend", "oracle"),
    ("--frontend", "superpoint", "--per-frame", "--match-thr", "0.4")],
    ids=["oracle", "per-frame"])
def test_per_frame_steps_do_not_wait_for_the_card(cuda_device, tmp_path,
                                                  capsys, route):
    """The command line's per-frame route on the card (tiny preset, 160x240,
    the mutual-NN oracle route and the learned one with its matcher's
    kernels): every `TrackingPipeline.step` that is not a BA trigger (where
    the health check reads the pose) runs under PyTorch's sync debug mode,
    which raises on an operation that makes the host wait for the stream.
    The async BA's fold at the step after a trigger is inside."""
    import json
    import os

    from gl_slam_tpu_torch import cli
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.io.kitti import write_kitti_sequence
    from gl_slam_tpu_torch.slam.pipeline import TrackingPipeline

    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
    scene = synthetic.make_scene(num_landmarks=700, num_frames=12,
                                 height=160, width=240, desc_dim=64, seed=23)
    root = write_kitti_sequence(str(tmp_path / "kitti"), scene, 12,
                                max_keypoints=96)
    step = TrackingPipeline.step
    strict = []

    def checked(self, *args, **kw):
        trigger = self._steps_since_check + 1 >= \
            self.cfg.runtime.ba_trigger_keyframes
        if not trigger:
            torch.cuda.set_sync_debug_mode("error")
        try:
            return step(self, *args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            strict.append(not trigger)

    TrackingPipeline.step = checked
    try:
        rc = cli.main(["run", "--dataset", root, "--preset", "tiny",
                       "--weights", ckpt, "--out", str(tmp_path / "out"),
                       "--first-frame", "0", "--last-frame", "11",
                       "--height", "160", "--width", "240", "--kpts", "96",
                       "--landmarks", "1500", *route])
    finally:
        TrackingPipeline.step = step
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    # 10 steps, BA trigger 7: the 7th step is the one not checked
    assert strict == [i != 6 for i in range(10)]
    assert report["frames_tracked"] == 12
    assert report["map"]["num_ba_runs"] == 1


def _revisit(dev):
    """A tiny tracked map (CPU, float32 networks), the features of frame 1
    extracted again, and the loop detector on `dev`: (cfg, K, state,
    frame-1 features, draws), all on `dev`."""
    import dataclasses
    import os

    from gl_slam_tpu_torch import config as t_cfg
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.slam import fused, loopclose
    from gl_slam_tpu_torch.slam import frontend
    from gl_slam_tpu_torch.train import e2e

    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
    H, W, N, D = 240, 320, 128, t_cfg.TINY_DESC_DIM
    cfg = t_cfg.micro_config(H, W, N, D)
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                  loop_closing=False))
    scene = synthetic.make_scene(num_landmarks=900, num_frames=18, height=H,
                                 width=W, desc_dim=D, seed=11)
    stack = e2e.render_stack(scene, 18, N)
    sp, lg = e2e.load_tiny_frontend(ckpt, device="cpu", dtype=torch.float32)
    diag = {}
    e2e.run_learned_e2e(sp, lg, scene, cfg, 18, chunk=8, ba_every=8,
                        device="cpu", stack=stack, diag_out=diag)
    kp, desc, valid = fused.build_extract_fn(cfg, sp)(
        torch.from_numpy(stack[1:2]))[:3]
    st = diag["state"]
    st = type(st)(type(st.map)(*(x.to(dev) for x in st.map)),
                  *(None if x is None else x.to(dev) for x in st[1:]))
    f = frontend.FrameFeatures(kp[0].to(dev), desc[0].to(dev),
                               valid[0].to(dev), None)
    gen = torch.Generator().manual_seed(0)
    g = loopclose.pnp_draws(gen, (cfg.runtime.loop_candidates,
                                  cfg.geometry.pnp_hypotheses,
                                  st.map.kf_db_idx.shape[1])).to(dev)
    K = torch.as_tensor(scene.K, dtype=torch.float32, device=dev)
    return cfg, K, st, f, g, scene


def test_detect_and_close_on_the_card_like_the_cpu(cuda_device):
    """`detect_loop_db` (the learned matcher in bf16: attention and
    assignment kernels on the card, their plain versions on the CPU) on a
    revisit of frame 1 by its own features, then `close_loop` of that
    detection onto the newest keyframe (a 16 m correction along the
    chain), on the card against the same calls on the CPU."""
    from gl_slam_tpu_torch.slam import fused, loopclose
    from gl_slam_tpu_torch.train import e2e
    import os

    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        cfg, K, st, f, g, scene = _revisit(dev)
        _, lg = e2e.load_tiny_frontend(ckpt, device=dev)      # bf16
        match = fused.build_matcher(cfg, lg)
        R1 = torch.as_tensor(scene.poses_R[1], dtype=torch.float32,
                             device=dev)
        t1 = torch.as_tensor(scene.poses_t[1] + 0.3, dtype=torch.float32,
                             device=dev)
        launches = dict(_build.LAUNCHES)
        det = loopclose.detect_loop_db(cfg, K, st.map, f, g, min_gap=5,
                                       min_inliers=30, matcher=match,
                                       R_cur=R1, t_cur=t1)
        if dev.type == "cuda":
            assert _build.LAUNCHES["attention"] > launches["attention"]
            assert _build.LAUNCHES["assignment"] \
                == launches["assignment"] + 2
        out.append((cfg, K, st, det))
    (cfg, Kc, stc, dc), (_, Kg, stg, dg) = out
    assert bool(dc.ok) and bool(dg.ok), (int(dc.num_inliers),
                                         int(dg.num_inliers))
    assert int(dg.loop_kf) == int(dc.loop_kf) == 1
    # bf16 kernels against their plain versions: a few matches may flip
    assert abs(int(dg.num_inliers) - int(dc.num_inliers)) <= 5
    np.testing.assert_allclose(dg.R.cpu().numpy(), dc.R.numpy(), atol=2e-3)
    np.testing.assert_allclose(dg.t.cpu().numpy(), dc.t.numpy(), atol=5e-2)
    # the closure of the CPU's detection on both devices: the same graph
    # and warm start, 8 dense f32 GN steps in other summation orders
    last = int(stc.map.num_kf) - 1
    sc = loopclose.close_loop(cfg, Kc, stc, dc, max_graph_kf=12,
                              target_kf=last)
    sg = loopclose.close_loop(cfg, Kg, stg, type(dc)(*(
        None if x is None else x.to(cuda_device) for x in dc)),
        max_graph_kf=12, target_kf=last)
    np.testing.assert_allclose(sg.map.kf_R.cpu().numpy(),
                               sc.map.kf_R.numpy(), atol=1e-3)
    np.testing.assert_allclose(sg.map.kf_t.cpu().numpy(),
                               sc.map.kf_t.numpy(), atol=1e-2)
    assert torch.isfinite(sg.map.pts_xyz).all()
    assert float((sc.map.kf_t - stc.map.kf_t).abs().max()) > 1.0


def test_a_loop_check_does_not_wait_for_the_card(cuda_device):
    """One loop check of the driver (the PnP draws, the detector through
    the kernels, the pinned copy of its verdict) issues no operation that
    makes the host wait for the stream: PyTorch's sync debug mode would
    raise on one."""
    import dataclasses
    import os

    from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline
    from gl_slam_tpu_torch.train import e2e

    cfg, K, st, _, _, _ = _revisit(cuda_device)
    cfg = cfg.replace(runtime=dataclasses.replace(
        cfg.runtime, loop_closing=True, loop_min_gap=5))
    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
    sp, lg = e2e.load_tiny_frontend(ckpt, device=cuda_device)
    pipe = ChunkedPipeline(cfg, K.cpu().numpy(), sp, lg, device=cuda_device)
    pipe.bootstrap_from_state(st, num_frames=18)
    pipe._dispatch_detect()                 # first call: kernels loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe._dispatch_detect()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host_ok, event, det = pipe._pending_loop
    assert host_ok.is_pinned() and event is not None
    event.synchronize()
    assert bool(host_ok) == bool(det.ok.cpu())
    assert [c["frames"] for c in pipe.loop_checks] == [18, 18]


def _tiny_chunked(cuda_device, map_kw=None, runtime_kw=None):
    """The tiny pipeline on the card (bfloat16 networks, 240x320, N=128,
    chunks of 5 with BA every 5, loop closing off) with config overrides,
    bootstrapped on a rendered scene -> (pipe, stack)."""
    import dataclasses
    import os

    from gl_slam_tpu_torch import config as t_cfg
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline
    from gl_slam_tpu_torch.train import e2e

    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
    H, W, N, D = 240, 320, 128, t_cfg.TINY_DESC_DIM
    cfg = t_cfg.micro_config(H, W, N, D)
    cfg = cfg.replace(
        map=dataclasses.replace(cfg.map, **(map_kw or {})),
        runtime=dataclasses.replace(cfg.runtime, loop_closing=False,
                                    **(runtime_kw or {})))
    scene = synthetic.make_scene(num_landmarks=900, num_frames=12, height=H,
                                 width=W, desc_dim=D, seed=11)
    stack = e2e.render_stack(scene, 12, N)
    sp, lg = e2e.load_tiny_frontend(ckpt, device=cuda_device)
    pipe = ChunkedPipeline(cfg, scene.K, sp, lg, chunk=5, ba_every=5,
                           device=cuda_device)
    c = [-scene.poses_R[i].T @ scene.poses_t[i] for i in (0, 1)]
    pipe.bootstrap_from_images(stack[0], stack[1],
                               float(np.linalg.norm(c[1] - c[0])))
    return pipe, stack


@pytest.mark.parametrize("map_kw,runtime_kw", [
    (dict(reobs_mode="merged"), {}), (dict(reobs_mode="batched"), {}),
    ({}, dict(tracker="pnp"))], ids=["merged", "batched", "pnp"])
def test_option_chunk_loop_does_not_wait_for_the_card(cuda_device, map_kw,
                                                      runtime_kw):
    """A chunk and its BA pass in the merged and batched re-observation
    modes and under the PnP tracker, after a first chunk, run under
    PyTorch's sync debug mode, which raises on an operation that makes the
    host wait for the stream."""
    pipe, stack = _tiny_chunked(cuda_device, map_kw, runtime_kw)
    pipe.track_chunk(stack[2:7])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.track_chunk(stack[7:12])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pipe.finish()
    o = pipe.stacked_outputs()
    assert o.frame_ok.all() and pipe.num_ba_runs == 2
    assert np.isfinite(o.t).all() and pipe.recovery_frames == []


def test_motion_gated_chunk_loop_reads_the_card_once_a_frame(cuda_device):
    """Under motion gating with filters no frame passes, every frame of a
    chunk but the first takes the recovery branch, whose verdict read is
    the one host wait: exactly one per such frame, all in the chunk loop
    (slam/fused.py), none elsewhere (PyTorch's sync debug mode in "warn",
    with the Python stack of each warning)."""
    import os
    import traceback
    import warnings

    pipe, stack = _tiny_chunked(cuda_device, runtime_kw=dict(
        every_frame_keyframe=False, gt_mag_filter=1e6, gt_rot_filter=1e6))
    pipe.track_chunk(stack[2:7])
    torch.cuda.synchronize()
    seen = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            seen.append([f"{os.path.basename(f.filename)}:{f.name}"
                         for f in traceback.extract_stack()])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pipe.track_chunk(stack[7:12])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    pipe.finish()
    assert len(seen) == 5 - 1, seen
    assert all("fused.py:chunk_fn" in stack for stack in seen), seen
    assert pipe.recovery_frames == [3, 4, 5, 6, 8, 9, 10, 11]
    o = pipe.stacked_outputs()
    assert not o.frame_ok.any() and int(pipe.state.map.num_kf) == 2
    assert pipe.num_recoveries == 0 and np.isfinite(o.t).all()


def test_kernels_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros(2, 8, 48, dtype=torch.bfloat16, device=cuda_device)
    m = torch.ones(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        t_attn.attention_cuda(q, q, q, m, 0.1)
    with pytest.raises(ValueError, match="bfloat16"):
        t_attn.attention_cuda(q.float(), q.float(), q.float(), m, 0.1)
    heat = torch.zeros(2, 16, 24, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        t_nms.nms(heat.double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        t_nms.nms(heat.transpose(1, 2), 2)
    with pytest.raises(ValueError, match="radius"):
        t_nms.nms(heat, 17)


def test_kernels_refuse_a_grid_past_the_card_limits(cuda_device):
    """More (set, head) pairs or pairs than grid z takes raise before any
    launch (the multi-stream chunk grows the batch with the streams)."""
    q = torch.zeros(65536, 1, 1, 32, dtype=torch.bfloat16, device=cuda_device)
    m = torch.ones(65536, 1, dtype=torch.bool, device=cuda_device)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="65535"):
        t_attn.attention_cuda(q, q, q, m, 0.1)
    f = torch.zeros(65536, 1, 64, dtype=torch.bfloat16, device=cuda_device)
    c = torch.zeros(65536, 1, device=cuda_device)
    with pytest.raises(ValueError, match="65535"):
        t_asg.fused_reductions_cuda(f, f, c, c, m, m, 0.1)
    assert dict(_build.LAUNCHES) == before


def test_multistream_chunk_on_the_card_like_single_streams(cuda_device):
    """Three streams of the tiny pipeline (240x320, N=128) through one
    multi-stream chunk on the card: attention and assignment launch as
    often as for one stream's chunk, NMS once per group of streams, no
    host wait (PyTorch's sync debug mode), and each stream keeps the
    frames of its own single-stream chunk on the card (same draws), both
    held to tests/test_torch_slice.py's tracking bound (ATE < 1 m against
    the ground truth). Poses are not compared frame by frame here: the
    bfloat16 matcher's batched products sum in another order than its
    unbatched ones, and on these 128-keypoint scenes a changed match moves
    a pose by more than the 5e-2 m whole-run bound (chip_smoke.py phase 10
    holds each stream to its single-stream run at flagship width)."""
    import dataclasses
    import os

    from gl_slam_tpu_torch import config as t_cfg
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.slam import fused
    from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline
    from gl_slam_tpu_torch.train import e2e

    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
    H, W, N, D, T, S = 240, 320, 128, t_cfg.TINY_DESC_DIM, 8, 3
    cfg = t_cfg.micro_config(H, W, N, D)
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                  loop_closing=False))
    scenes = [synthetic.make_scene(num_landmarks=900, num_frames=2 + T,
                                   height=H, width=W, desc_dim=D,
                                   seed=11 + s) for s in range(S)]
    stacks = [e2e.render_stack(sc, 2 + T, N) for sc in scenes]
    sp, lg = e2e.load_tiny_frontend(ckpt, device=cuda_device)
    states = []
    for sc, st in zip(scenes, stacks):
        pipe = ChunkedPipeline(cfg, sc.K, sp, lg, chunk=T,
                               device=cuda_device)
        c = [-sc.poses_R[i].T @ sc.poses_t[i] for i in (0, 1)]
        pipe.bootstrap_from_images(st[0], st[1],
                                   float(np.linalg.norm(c[1] - c[0])))
        states.append(pipe.state)
    state = type(states[0])(*(
        None if x is None else
        type(x)(*(torch.stack([getattr(s_.map, f) for s_ in states])
                  for f in x._fields)) if isinstance(x, tuple)
        else torch.stack([getattr(s_, n) for s_ in states])
        for n, x in zip(states[0]._fields, states[0])))
    images = torch.from_numpy(np.stack([st[2:] for st in stacks])).to(
        cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    u = torch.rand((S, T, cfg.geometry.essential_hypotheses, 8),
                   generator=g, device=cuda_device)
    one = fused.build_chunk_fn(cfg, sp, lg, pipe.K, T)
    singles = []
    before = dict(_build.LAUNCHES)
    for s in range(S):
        singles.append(one(states[s], images[s], 2, u[s]))
        if s == 0:
            single = {k: _build.LAUNCHES[k] - before[k] for k in before}
    fn = fused.build_multistream_chunk_fn(cfg, sp, lg, scenes[0].K, T, S,
                                          extract_group=1)
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        st_b, outs, _ = fn(state, images, 2, u)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert got["attention"] == single["attention"] > 0
    assert got["assignment"] == single["assignment"] > 0
    assert got["nms"] == S * single["nms"]
    assert bool(outs[-1].frame_ok.all())

    def ate(R, t, sc):
        c_est = np.einsum('kij,kj->ki', R.transpose(0, 2, 1), -t)
        c_gt = np.stack([-sc.poses_R[i].T @ sc.poses_t[i]
                         for i in range(len(t))])
        return float(np.sqrt(((c_est - c_gt) ** 2).sum(1).mean()))

    n = 2 + T
    for s, (st1, outs1, _) in enumerate(singles):
        for a, b in zip(outs1, outs):
            assert bool(a.frame_ok == b.frame_ok[s])
        assert int(st1.map.num_kf) == int(st_b.map.num_kf[s]) == n
        for m in (st1.map, type(st1.map)(*(x[s] for x in st_b.map))):
            R, t = m.kf_R[:n].cpu().numpy(), m.kf_t[:n].cpu().numpy()
            assert np.isfinite(R).all() and np.isfinite(t).all()
            assert ate(R, t, scenes[s]) < 1.0
