"""The classical front end (Harris corners, patch descriptors): the port
against the JAX package on rendered frames.

Frames of the rendered scenes the CLI tests use (160x240, seed 23, the
KITTI layout's; 240x320, seed 42), batch of two. The JAX extractor is
jitted and vmapped; the port's runs its plain NMS on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gl_slam_tpu.io import synthetic
from gl_slam_tpu.models import classical as j_cls
from gl_slam_tpu_torch.models import classical as t_cls

torch.set_num_threads(1)

SCENES = [(160, 240, 96, 23), (240, 320, 256, 42)]


def _frames(H, W, N, seed):
    scene = synthetic.make_scene(num_landmarks=700, num_frames=3, height=H,
                                 width=W, desc_dim=64, seed=seed)
    return np.stack([np.asarray(synthetic.render_frame(
        scene, i, max_keypoints=N), np.float32) for i in (0, 2)])


@pytest.mark.parametrize("H,W,N,seed", SCENES)
def test_box_blur_and_harris_response_match_jax(H, W, N, seed):
    """The blur sums its taps in XLA's order: equal bits. The response
    (eager JAX, op by op) differs only where XLA flushes a denormal
    product to zero (|diff| < 1e-37)."""
    img = _frames(H, W, N, seed)[0]
    np.testing.assert_array_equal(
        t_cls._box_blur(torch.from_numpy(img)).numpy(),
        np.asarray(j_cls._box_blur(jnp.asarray(img))))
    got = t_cls.harris_response(torch.from_numpy(img)).numpy()
    want = np.asarray(j_cls.harris_response(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-37)
    assert (np.abs(want) > 1e-6).sum() > 100


@pytest.mark.parametrize("H,W,N,seed", SCENES)
def test_patch_descriptors_match_jax(H, W, N, seed):
    img = _frames(H, W, N, seed)[0]
    rng = np.random.default_rng(seed)
    kpts = np.stack([rng.uniform(-2, W + 2, N), rng.uniform(-2, H + 2, N)],
                    -1).astype(np.float32)
    got = t_cls.patch_descriptors(torch.from_numpy(img),
                                  torch.from_numpy(kpts)).numpy()
    want = np.asarray(j_cls.patch_descriptors(jnp.asarray(img),
                                              jnp.asarray(kpts)))
    # unit-norm 64-vectors: f32 sums in another order, ~1e-7 apart
    np.testing.assert_allclose(got, want, atol=1e-6)
    # unit norm except on (nearly) flat patches
    norm = np.linalg.norm(got, axis=-1)
    assert np.isclose(norm, 1.0, atol=1e-5).sum() > N // 4


@pytest.mark.parametrize("H,W,N,seed", SCENES)
def test_harris_extractor_matches_jax(H, W, N, seed):
    """Keypoints and validity exact; scores within 1e-6 relative (the
    jitted JAX response may contract a product and a sum into one rounding,
    the port rounds twice); descriptors within 1e-6."""
    imgs = _frames(H, W, N, seed)
    kj, sj, dj, vj = (np.asarray(a) for a in
                      j_cls.HarrisExtractor(H, W, max_keypoints=N)(
                          jnp.asarray(imgs)))
    kt, st, dt, vt = (a.numpy() for a in
                      t_cls.HarrisExtractor(H, W, max_keypoints=N)(
                          torch.from_numpy(imgs)))
    assert kt.dtype == np.float32 and dt.shape == (2, N, 64)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(vt, vj)
    assert vt.sum(1).min() > N // 2
    np.testing.assert_allclose(st, sj, rtol=1e-6, atol=0)
    np.testing.assert_allclose(dt, dj, atol=1e-6)
