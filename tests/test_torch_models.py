"""The port's networks, detection and checkpoints against the JAX package.

Weights come from the committed checkpoints through
gl_slam_tpu_torch/checkpoint.py; the JAX references are built with
dtype=float32 by constructor argument, at "highest" matmul precision
(tests/conftest.py). Inputs come from a numpy seed.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu.checkpoint import load_params as j_load
from gl_slam_tpu.models.lightglue import LightGlueNet as JLightGlue
from gl_slam_tpu.models.superpoint import SuperPointNet as JSuperPoint
from gl_slam_tpu.models.superpoint import sample_descriptors as j_sample
from gl_slam_tpu.ops import nms as j_nms
from gl_slam_tpu.train import e2e as j_e2e
from gl_slam_tpu_torch import checkpoint as ckpt
from gl_slam_tpu_torch import config as t_cfg
from gl_slam_tpu_torch.models.lightglue import LightGlueNet
from gl_slam_tpu_torch.models.superpoint import (SuperPointNet,
                                                 sample_descriptors)
from gl_slam_tpu_torch.ops import nms as t_nms
from gl_slam_tpu_torch.train import e2e as t_e2e

import jax_weights

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
D = t_cfg.TINY_DESC_DIM


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def lightglue_pair():
    jl = JLightGlue(input_dim=D, dtype=jnp.float32, **j_e2e.TINY_LG)
    d8, k8, m8 = jnp.zeros((8, D)), jnp.zeros((8, 2)), jnp.ones((8,), bool)
    jp = j_load(os.path.join(CKPT, "lg_tiny.npz"),
                jax_weights.like(jl, d8, d8, k8, k8, m8, m8))
    tl = LightGlueNet(input_dim=D, dtype=torch.float32, **t_cfg.TINY_LG)
    ckpt.load_module(tl, os.path.join(CKPT, "lg_tiny.npz"),
                     ckpt.lightglue_state_dict)
    return jl, jp, tl


# Equal sizes take GlueLayer's batched path, unequal sizes the per-set one.
@pytest.mark.parametrize("N,M", [(48, 48), (24, 56)])
def test_lightglue_matches_jax(lightglue_pair, N, M):
    jl, jp, tl = lightglue_pair
    rng = np.random.default_rng(N + M)
    d0 = rng.standard_normal((N, D)).astype(np.float32)
    d1 = rng.standard_normal((M, D)).astype(np.float32)
    k0 = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    k1 = rng.uniform(-1, 1, (M, 2)).astype(np.float32)
    m0 = rng.uniform(size=N) < 0.8
    m1 = rng.uniform(size=M) < 0.8
    ref = jl.apply(jp, d0, d1, k0, k1, m0, m1, return_features=True)
    with torch.no_grad():
        got = tl(*_t(d0, d1, k0, k1, m0, m1), return_features=True)
        sim, z0, z1 = tl(*_t(d0, d1, k0, k1, m0, m1))
    # float32 through 2 layers of O(10-100) activations: relative 1e-4
    for r, g in zip(ref, got):
        assert _rel(g.numpy(), r) < 1e-4
    jsim, _, _ = jl.apply(jp, d0, d1, k0, k1, m0, m1)
    assert _rel(sim.numpy(), jsim) < 1e-4


def test_lightglue_batch_dimension(lightglue_pair):
    """A leading pair axis gives the per-pair results (the chunk prologue
    runs T pairs in one call)."""
    _, _, tl = lightglue_pair
    rng = np.random.default_rng(7)
    d = rng.standard_normal((3, 2, 32, D)).astype(np.float32)
    k = rng.uniform(-1, 1, (3, 2, 32, 2)).astype(np.float32)
    m = rng.uniform(size=(3, 2, 32)) < 0.8
    with torch.no_grad():
        batched = tl(*_t(d[:, 0], d[:, 1], k[:, 0], k[:, 1], m[:, 0],
                         m[:, 1]), return_features=True)
        for i in range(3):
            one = tl(*_t(d[i, 0], d[i, 1], k[i, 0], k[i, 1], m[i, 0],
                         m[i, 1]), return_features=True)
            for b, o in zip(batched, one):
                assert _rel(b[i].numpy(), o.numpy()) < 1e-5


@pytest.fixture(scope="module")
def superpoint_pair():
    js = JSuperPoint(descriptor_dim=D, channels=j_e2e.TINY_SP_CHANNELS,
                     dtype=jnp.float32)
    jp = j_load(os.path.join(CKPT, "sp_tiny.npz"),
                jax_weights.like(js, jnp.zeros((1, 32, 48, 1))))
    ts = SuperPointNet(descriptor_dim=D, channels=t_cfg.TINY_SP_CHANNELS,
                       dtype=torch.float32)
    ckpt.load_module(ts, os.path.join(CKPT, "sp_tiny.npz"),
                     ckpt.superpoint_state_dict)
    return js, jp, ts


def test_superpoint_and_detection_match_jax(superpoint_pair):
    js, jp, ts = superpoint_pair
    rng = np.random.default_rng(8)
    img = rng.uniform(size=(2, 64, 96, 1)).astype(np.float32)
    heat, grid = js.apply(jp, img)
    with torch.no_grad():
        th, tg = ts(*_t(img))
    # float32 convolutions in other summation orders: relative 1e-4
    np.testing.assert_allclose(th.numpy(), np.asarray(heat), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(tg.numpy(), np.asarray(grid), rtol=1e-4,
                               atol=1e-5)
    # Detection on the JAX heatmap itself, so the keypoint sets compare
    # exactly (ties included), then descriptor sampling at them.
    hj = np.asarray(heat)
    kj, sj, vj = j_nms.detect_keypoints(jnp.asarray(hj), 64, 0.005, 3)
    kt, st, vt = t_nms.detect_keypoints(*_t(hj), 64, 0.005, 3)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=0)
    kf = np.asarray(kj, np.float32) + 0.3
    dj = jax.vmap(j_sample)(grid, jnp.asarray(kf))
    dt = sample_descriptors(*_t(np.asarray(grid), kf))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)


@pytest.mark.parametrize("two_stage", [True, False])
def test_detect_keypoints_plateau_ties_like_lax_top_k(two_stage):
    """Plateaus (equal scores) and the zeros of a suppressed map must
    resolve to the lower index, as lax.top_k does."""
    rng = np.random.default_rng(9)
    H, W = (40, 64) if two_stage else (12, 16)
    heat = np.round(rng.uniform(size=(2, H, W)), 1).astype(np.float32)
    heat[0, 5:15, 10:30] = 0.7           # a plateau
    heat[1] = 0.0
    heat[1, 3, 4] = heat[1, 9, 2] = 0.5  # equal isolated peaks
    K = 100 if two_stage else 60
    kj, sj, vj = j_nms.detect_keypoints(jnp.asarray(heat), K, 0.05, 2)
    kt, st, vt = t_nms.detect_keypoints(*_t(heat), K, 0.05, 2)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("preset", ["tiny", "flagship"])
def test_checkpoints_load_with_exact_shapes(preset):
    """Every parameter of the committed checkpoints finds its counterpart
    with the converted shape (load_module is strict), and a forward pass
    at a small /8 resolution gives the expected shapes."""
    if not os.path.exists(os.path.join(CKPT, f"sp_{preset}.npz")):
        pytest.skip(f"no committed {preset} checkpoints")
    load = t_e2e.load_tiny_frontend if preset == "tiny" \
        else t_e2e.load_flagship_frontend
    sp, lg = load(CKPT, device="cpu", dtype=torch.float32)
    Dp = t_cfg.TINY_DESC_DIM if preset == "tiny" else t_cfg.FLAGSHIP_DESC_DIM
    lg_shape = t_cfg.TINY_LG if preset == "tiny" else t_cfg.FLAGSHIP_LG
    assert len(lg.layers) == lg_shape["layers"]
    assert lg.layers[0].self_attn.heads == lg_shape["heads"]
    assert sp.desc.weight.shape == (Dp, 256, 1, 1)
    flat = ckpt.load_params(os.path.join(CKPT, f"lg_{preset}.npz"))
    assert len(ckpt.lightglue_state_dict(flat)) == len(lg.state_dict())
    with torch.no_grad():
        heat, grid = sp(torch.zeros(1, 32, 48, 1))
        d = torch.zeros(16, Dp)
        k = torch.zeros(16, 2)
        m = torch.ones(16, dtype=torch.bool)
        sim, z0, _ = lg(d, d, k, k, m, m)
    assert heat.shape == (1, 32, 48) and grid.shape == (1, 4, 6, Dp)
    assert sim.shape == (16, 16) and bool(torch.isfinite(sim).all())
