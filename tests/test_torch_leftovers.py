"""The rest of the JAX package's public names in the port, each against its
JAX function, at the sizes of tests/test_{smallmat,select,geometry,
models}.py:

  * ops/smallmat `cg_solve` (96 x 96, 120 iterations) and
    `block_jacobi_pcg` (4 blocks of 6);
  * ops/select `select_{lowest,newest}_ids_{cumsum,ss}` (ids exact);
  * geometry/se3 `pose_matrix`, `from_pose_matrix`,
    `translation_direction_angle_deg`, `exp_so3_batched`,
    `log_so3_batched`;
  * geometry/essential `mask_filter`, `adjust_translation_magnitude`;
  * models/subpix `gather_patches_naive` (exact), `centroid_refine_naive`
    and `SubpixRefiner` (JAX's Flax initialisation, float32);
  * models/superpoint `SuperPointExtractor` (96 x 128, 64 keypoints,
    D 64; JAX's initialisation at float32) and models/lightglue
    `LightGlueMatcher` (input 32, dim 64, 2 heads, 2 layers), both on the
    CPU, and each equal bit for bit to the chunk's own extraction and
    matcher;
  * slam/fused `FusedParams`, slam/reobserve `CovisResult`, train/e2e
    `flagship_config` / `micro_config`, ops/precision `f32`, parallel/mesh
    `stream_sharding` / `replicated`.

Float tolerances: 1e-6 for closed forms in float32, 1e-5 relative to 1 for
network outputs in float32 (the convolutions and matmuls of the two
frameworks sum in other orders), 1e-3 relative for the iterative solvers
(the JAX test's bound against numpy).
"""

from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu import checkpoint as j_ckpt
from gl_slam_tpu.geometry import essential as j_ess
from gl_slam_tpu.geometry import se3 as j_se3
from gl_slam_tpu.models import lightglue as j_lg
from gl_slam_tpu.models import subpix as j_subpix
from gl_slam_tpu.models import superpoint as j_sp
from gl_slam_tpu.ops import select as j_select
from gl_slam_tpu.ops import smallmat as j_sm
from gl_slam_tpu.slam import fused as j_fused
from gl_slam_tpu.slam import reobserve as j_reobserve
from gl_slam_tpu_torch import checkpoint as ckpt
from gl_slam_tpu_torch import config as t_config
from gl_slam_tpu_torch.geometry import essential, se3
from gl_slam_tpu_torch.models import lightglue, subpix, superpoint
from gl_slam_tpu_torch.ops import precision, select, smallmat
from gl_slam_tpu_torch.parallel import mesh
from gl_slam_tpu_torch.slam import fused, reobserve
from gl_slam_tpu_torch.train import e2e

torch.set_num_threads(1)

H, W = 96, 128


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _port_module(module, params, convert, tmp_path, name):
    """`module` loaded with a JAX parameter tree (through an npz, as the
    checkpoints travel)."""
    path = str(tmp_path / f"{name}.npz")
    j_ckpt.save_params(path, params)
    ckpt.load_module(module, path, convert)
    return module


# ------------------------------------------------------------- smallmat

def test_cg_solve_matches_jax():
    rng = np.random.default_rng(6)
    A96 = rng.normal(size=(200, 96)).astype(np.float32)
    Hm = A96.T @ A96 + 5.0 * np.eye(96, dtype=np.float32)
    b = rng.normal(size=96).astype(np.float32)
    got = _np(smallmat.cg_solve(_t(Hm), _t(b), 120))
    ref = np.asarray(j_sm.cg_solve(jnp.asarray(Hm), jnp.asarray(b), 120))
    xr = np.linalg.solve(Hm, b)
    for x in (got, ref):
        assert np.linalg.norm(x - xr) / np.linalg.norm(xr) < 1e-3
    assert np.linalg.norm(got - ref) / np.linalg.norm(xr) < 1e-3
    # batched, as the JAX function's leading axes
    Hb, bb = np.stack([Hm, 2 * Hm]), np.stack([b, -b])
    got_b = _np(smallmat.cg_solve(_t(Hb), _t(bb), 120))
    np.testing.assert_allclose(got_b[0], got, rtol=1e-5, atol=1e-6)


def test_block_jacobi_pcg_matches_jax():
    rng = np.random.default_rng(7)
    C = 4
    A = rng.normal(size=(40, 6 * C)).astype(np.float32)
    # rotation-vs-translation scale mix in each block
    A[:, 3::6] *= 30.0
    Hm = A.T @ A + np.eye(6 * C, dtype=np.float32)
    Sb = Hm.reshape(C, 6, C, 6).transpose(0, 2, 1, 3).copy()
    b = rng.normal(size=(C, 6)).astype(np.float32)
    got = _np(smallmat.block_jacobi_pcg(_t(Sb), _t(b), 40))
    ref = np.asarray(j_sm.block_jacobi_pcg(jnp.asarray(Sb), jnp.asarray(b),
                                           40))
    xr = np.linalg.solve(Hm.astype(np.float64), b.reshape(-1)).reshape(C, 6)
    assert np.linalg.norm(ref - xr) / np.linalg.norm(xr) < 1e-3
    assert np.linalg.norm(got - xr) / np.linalg.norm(xr) < 1e-3
    assert np.linalg.norm(got - ref) / np.linalg.norm(xr) < 1e-3


# --------------------------------------------------------------- select

VARIANTS = ["select_lowest_ids_cumsum", "select_lowest_ids_ss",
            "select_newest_ids_cumsum", "select_newest_ids_ss"]


@pytest.mark.parametrize("name", VARIANTS)
@pytest.mark.parametrize("seed,n,m,p", [(0, 100, 16, 0.3), (1, 4096, 256, 0.1),
                                        (2, 64, 64, 0.9), (3, 128, 8, 0.9),
                                        (4, 32, 8, 0.0)])
def test_select_variants_match_jax(name, seed, n, m, p):
    mask = np.random.default_rng(seed).random(n) < p
    ids, valid = getattr(select, name)(_t(mask), m)
    rids, rvalid = getattr(j_select, name)(jnp.asarray(mask), m)
    assert ids.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(_np(ids), np.asarray(rids))
    np.testing.assert_array_equal(_np(valid), np.asarray(rvalid))
    # and the port's sort-based selection of the same order
    base = "select_lowest_ids" if "lowest" in name else "select_newest_ids"
    np.testing.assert_array_equal(_np(ids),
                                  _np(getattr(select, base)(_t(mask), m)[0]))


# ------------------------------------------------------------ se3, essential

def test_se3_leftovers_match_jax():
    rng = np.random.default_rng(8)
    w = rng.normal(size=(5, 3)).astype(np.float32) * 0.7
    R = _np(se3.exp_so3_batched(_t(w)))
    np.testing.assert_allclose(R, np.asarray(j_se3.exp_so3_batched(
        jnp.asarray(w))), atol=1e-6)
    np.testing.assert_allclose(_np(se3.log_so3_batched(_t(R))),
                               np.asarray(j_se3.log_so3_batched(
                                   jnp.asarray(R))), atol=1e-5)
    t = rng.normal(size=3).astype(np.float32)
    T = se3.pose_matrix(_t(R[0]), _t(t))
    np.testing.assert_array_equal(_np(T), np.asarray(j_se3.pose_matrix(
        jnp.asarray(R[0]), jnp.asarray(t))))
    R2, t2 = se3.from_pose_matrix(T)
    np.testing.assert_array_equal(_np(R2), R[0])
    np.testing.assert_array_equal(_np(t2), t)
    for t1 in (rng.normal(size=3), -t, t * 3.0, np.zeros(3)):
        t1 = np.asarray(t1, np.float32)
        got = float(se3.translation_direction_angle_deg(_t(t1), _t(t)))
        ref = float(j_se3.translation_direction_angle_deg(jnp.asarray(t1),
                                                          jnp.asarray(t)))
        assert abs(got - ref) < 1e-3, (got, ref)


def test_essential_leftovers_match_jax():
    rng = np.random.default_rng(9)
    pm, inl = rng.random(50) < 0.7, rng.random(50) < 0.5
    uv = rng.normal(size=(50, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(essential.mask_filter(_t(uv), _t(uv), _t(pm), _t(inl))),
        np.asarray(j_ess.mask_filter(jnp.asarray(uv), jnp.asarray(uv),
                                     jnp.asarray(pm), jnp.asarray(inl))))
    t = np.asarray([0.0, 0.0, 2.0], np.float32)
    a, b = np.zeros(3, np.float32), np.asarray([3.0, 0.0, 0.0], np.float32)
    got = _np(essential.adjust_translation_magnitude(_t(t), _t(a), _t(b)))
    ref = np.asarray(j_ess.adjust_translation_magnitude(
        jnp.asarray(t), jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert np.linalg.norm(got) == pytest.approx(3.0, rel=1e-5)


# --------------------------------------------------------------- subpix

def test_naive_gathers_match_jax():
    rng = np.random.default_rng(3)
    Hh, Ww, N, P = 96, 200, 64, 7
    img = rng.normal(size=(Hh, Ww)).astype(np.float32)
    kp = np.stack([rng.uniform(0, Ww - 1, N), rng.uniform(0, Hh - 1, N)], 1)
    kp[:4] = [[0, 0], [Ww - 1, Hh - 1], [1.7, 0.2], [Ww - 1.2, 3.9]]
    kp = kp.astype(np.float32)
    got = _np(subpix.gather_patches_naive(_t(img), _t(kp), P))
    ref = np.asarray(j_subpix.gather_patches_naive(jnp.asarray(img),
                                                   jnp.asarray(kp), P))
    np.testing.assert_array_equal(got, ref)
    h = np.abs(img)
    got = _np(subpix.centroid_refine_naive(_t(h), _t(kp), P))
    ref = np.asarray(j_subpix.centroid_refine_naive(jnp.asarray(h),
                                                    jnp.asarray(kp), P))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # the port's gather equals the naive one below 16384 pixels
    small = img[:64, :128]
    kps = np.clip(kp, 0, 60)
    np.testing.assert_array_equal(
        _np(subpix.gather_patches(_t(small), _t(kps), P)),
        _np(subpix.gather_patches_naive(_t(small), _t(kps), P)))


def test_subpix_refiner_matches_jax(tmp_path):
    ref = j_subpix.SubpixRefiner(patch=5, desc_dim=16)
    ref.head = ref.head.clone(dtype=jnp.float32)
    ref._fn = jax.jit(ref._refine)
    head = _port_module(subpix.SubpixHead(16, patch=5, dtype=torch.float32),
                        ref.params, ckpt.subpix_state_dict, tmp_path, "ks")
    ours = subpix.SubpixRefiner(head=head, device="cpu")
    rng = np.random.default_rng(3)
    heat = rng.random((32, 32)).astype(np.float32)
    kpts = np.asarray([[10.0, 10.0], [20.0, 5.0], [0.0, 31.0]], np.float32)
    desc = rng.random((3, 16)).astype(np.float32)
    got = _np(ours(heat, kpts, desc))
    want = np.asarray(ref(jnp.asarray(heat), jnp.asarray(kpts),
                          jnp.asarray(desc)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - kpts).max() <= head.offset_range
    # the default head: Flax's initialisation from the seed, bounded
    fresh = subpix.SubpixRefiner(patch=5, desc_dim=16, device="cpu")
    assert np.abs(_np(fresh(heat, kpts, desc)) - kpts).max() \
        <= fresh.head.offset_range


# ---------------------------------------------------- extractor, matcher

@pytest.fixture(scope="module")
def extractor_pair(tmp_path_factory):
    ref = j_sp.SuperPointExtractor(H, W, max_keypoints=64,
                                   score_threshold=0.0, descriptor_dim=64,
                                   use_pallas=False)
    ref.net = ref.net.clone(dtype=jnp.float32)
    ref._fn = jax.jit(ref._extract)
    net = _port_module(superpoint.SuperPointNet(64, dtype=torch.float32),
                       ref.params, ckpt.superpoint_state_dict,
                       tmp_path_factory.mktemp("sp"), "sp")
    ours = superpoint.SuperPointExtractor(H, W, max_keypoints=64,
                                          score_threshold=0.0,
                                          descriptor_dim=64, net=net,
                                          device="cpu")
    return ref, ours


def test_superpoint_extractor_matches_jax(extractor_pair):
    ref, ours = extractor_pair
    imgs = np.random.default_rng(1).random((2, H, W)).astype(np.float32)
    kpts, scores, desc, valid = (_np(x) for x in ours(imgs))
    rk, rs, rd, rv = (np.asarray(x) for x in ref(jnp.asarray(imgs)))
    assert kpts.shape == (2, 64, 2) and desc.shape == (2, 64, 64)
    assert kpts.dtype == np.float32 and valid.dtype == bool
    np.testing.assert_array_equal(valid, rv)
    np.testing.assert_array_equal(kpts, rk)
    np.testing.assert_allclose(scores, rs, atol=1e-5)
    np.testing.assert_allclose(desc, rd, atol=1e-5)
    assert (np.diff(scores, axis=1) <= 1e-6).all()


def test_superpoint_extractor_is_the_chunks_extraction(extractor_pair):
    """With a one-pixel refinement window the chunk's extraction leaves the
    integer detections where they are: its output equals the extractor's,
    bit for bit."""
    import dataclasses
    _, ours = extractor_pair
    cfg = t_config.micro_config(H, W, 64, 64)
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, score_threshold=0.0, nms_radius=4, subpix_patch=1))
    imgs = torch.from_numpy(
        np.random.default_rng(2).random((2, H, W)).astype(np.float32))
    kpts, _, desc, valid = ours(imgs)
    with torch.no_grad():
        k2, d2, v2 = fused.build_extract_fn(cfg, ours.net)(imgs)
    assert torch.equal(kpts, k2) and torch.equal(desc, d2)
    assert torch.equal(valid, v2)


@pytest.fixture(scope="module")
def matcher_pair(tmp_path_factory):
    ref = j_lg.LightGlueMatcher(H, W, input_dim=32, dim=64, heads=2,
                                layers=2, threshold=0.0)
    ref.net = ref.net.clone(dtype=jnp.float32)
    ref._fn = jax.jit(ref._match_batch)
    net = _port_module(
        lightglue.LightGlueNet(dim=64, heads=2, layers=2, input_dim=32,
                               dtype=torch.float32),
        ref.params, ckpt.lightglue_state_dict,
        tmp_path_factory.mktemp("lg"), "lg")
    ours = lightglue.LightGlueMatcher(H, W, input_dim=32, dim=64, heads=2,
                                      layers=2, threshold=0.0, net=net,
                                      device="cpu")
    return ref, ours


def _match_inputs(seed, N=32):
    rng = np.random.default_rng(seed)
    d0 = rng.normal(size=(2, N, 32)).astype(np.float32)
    d1 = d0 + 0.3 * rng.normal(size=(2, N, 32)).astype(np.float32)
    k0 = rng.uniform(0, [W, H], size=(2, N, 2)).astype(np.float32)
    k1 = k0 + rng.normal(size=(2, N, 2)).astype(np.float32)
    v0 = np.ones((2, N), bool)
    v0[0, 20:] = False
    v1 = rng.random((2, N)) < 0.9
    return k0, d0, v0, k1, d1, v1


def test_lightglue_matcher_matches_jax(matcher_pair):
    ref, ours = matcher_pair
    ins = _match_inputs(2)
    got = ours(*ins)
    want = ref(*(jnp.asarray(x) for x in ins))
    assert got.scores is None
    for name in ("matches0", "matches1"):
        g = _np(getattr(got, name))
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(getattr(want, name)))
    for name in ("mscores0", "mscores1"):
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5)
    m0 = _np(got.matches0)
    assert (m0[0, 20:] == -1).all() and (m0 >= 0).sum() > 10


def test_lightglue_matcher_is_the_chunks_matcher(matcher_pair):
    _, ours = matcher_pair
    cfg = t_config.micro_config(H, W, 32, 32)
    ins = [torch.from_numpy(x) for x in _match_inputs(3)]
    got = ours(*ins)
    with torch.no_grad():
        want = fused.build_matcher(cfg, ours.net)(*ins)
    assert torch.equal(got.matches0, want.matches0)
    assert torch.equal(got.mscores0, want.mscores0)


def test_extractor_and_matcher_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        superpoint.SuperPointExtractor(H, W, descriptor_dim=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lightglue.LightGlueMatcher(H, W, input_dim=32, dim=64, heads=2,
                                   layers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        subpix.SubpixRefiner(desc_dim=16)


# ---------------------------------------------------- names and placements

def test_named_tuples_have_the_jax_fields():
    assert fused.FusedParams._fields == j_fused.FusedParams._fields
    assert fused.FusedParams(1, 2).ks is None
    assert reobserve.CovisResult._fields == j_reobserve.CovisResult._fields
    assert e2e.flagship_config is t_config.flagship_config
    assert e2e.micro_config is t_config.micro_config
    assert e2e.flagship_config().frontend.max_keypoints == 2048


def test_f32_runs_the_call_with_tf32_off():
    seen = {}

    @precision.f32
    def call(x):
        seen["tf32"] = (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32,
                        torch.get_float32_matmul_precision())
        return x + 1

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert call(1) == 2
        assert seen["tf32"] == (False, False, "highest")
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]
        torch.set_float32_matmul_precision(before[2])
    assert call.__f32_precision__ is True
    assert call.__name__ == "call"


class _Inner(NamedTuple):
    a: torch.Tensor
    b: Optional[torch.Tensor]


class _Tree(NamedTuple):
    x: torch.Tensor
    inner: _Inner


def test_mesh_placements():
    """Trees are named tuples of tensors (the port's states)."""
    x = torch.arange(12.0).reshape(4, 3)
    tree = _Tree(x, _Inner(x[:, 0], None))
    parts = mesh.stream_sharding(["cpu", "cpu"])(tree)
    assert len(parts) == 2
    assert torch.equal(parts[1][0], x[2:])
    assert parts[1][1][1] is None
    copies = mesh.replicated(["cpu", "cpu"])(tree)
    assert len(copies) == 2
    assert all(torch.equal(c[0], x) for c in copies)
    assert copies[0][1][0].device == torch.device("cpu")
