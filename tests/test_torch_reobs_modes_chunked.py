"""The merged and batched re-observation modes on the chunked learned
tracker: the port against JAX.

The JAX ChunkedPipeline and the port's (run_learned_e2e) track a bootstrap
plus one chunk of 8 of tests/test_torch_slice.py's 240x320 scene with BA
off, on the JAX key recurrence's RANSAC draws, in each mode; held to that
file's first-chunk tolerances. The functions and the per-frame route are
in tests/test_torch_reobs_modes.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gl_slam_tpu.slam import fused as j_fused
from gl_slam_tpu.slam.chunk_driver import ChunkedPipeline as JChunked
from gl_slam_tpu.train import e2e as j_e2e
from gl_slam_tpu_torch import config as t_config
from gl_slam_tpu_torch.train import e2e as t_e2e

import test_torch_slice as ts_mod
import jax_weights

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

MODES = ["merged", "batched"]


def with_mode(cfg, mode):
    return dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, reobs_mode=mode))


NF_CHUNKED = 2 + ts_mod.CHUNK


@pytest.fixture(scope="module")
def chunked_runs():
    """Per mode, the JAX ChunkedPipeline's and the port's per-frame outputs
    over a bootstrap plus one chunk of 8 of tests/test_torch_slice.py's
    scene, BA off, on the JAX key recurrence's RANSAC draws."""
    scene, stack, scale = ts_mod._scene()
    sp, spp, lg, lgp = jax_weights.load_tiny_frontend(ts_mod.CKPT)
    sp, lg = sp.clone(dtype=jnp.float32), lg.clone(dtype=jnp.float32)
    tsp, tlg = t_e2e.load_tiny_frontend(ts_mod.CKPT, device="cpu",
                                        dtype=torch.float32)
    runs = {}
    for mode in MODES:
        jcfg = with_mode(ts_mod._backend(j_e2e.micro_config(
            ts_mod.H, ts_mod.W, ts_mod.N, j_e2e.TINY_DESC_DIM), False), mode)
        jp = JChunked(jcfg, jnp.asarray(scene.K, jnp.float32), sp, lg,
                      j_fused.FusedParams(sp=spp, lg=lgp),
                      chunk=ts_mod.CHUNK, enable_ba=False)
        jp.bootstrap_from_images(stack[0], stack[1], scale)
        jp.track_chunk(jnp.asarray(stack[2:NF_CHUNKED]), 2)
        feed, pos = ts_mod._jax_draws(jcfg)
        tcfg = with_mode(ts_mod._backend(t_config.micro_config(
            ts_mod.H, ts_mod.W, ts_mod.N, t_config.TINY_DESC_DIM), False),
            mode)
        diag = {}
        res = t_e2e.run_learned_e2e(tsp, tlg, scene, tcfg, NF_CHUNKED,
                                    chunk=ts_mod.CHUNK, device="cpu",
                                    draws=feed, stack=stack[:NF_CHUNKED],
                                    diag_out=diag)
        assert pos[0] == NF_CHUNKED - 1      # every draw set consumed
        runs[mode] = (jp.stacked_outputs(), diag["outputs"], res)
    return runs


@pytest.mark.parametrize("mode", MODES)
def test_chunked_mode_matches_jax(chunked_runs, mode):
    ref, got, res = chunked_runs[mode]
    np.testing.assert_array_equal(got.frame_ok, ref.frame_ok)
    np.testing.assert_array_equal(got.num_matches, ref.num_matches)
    # tests/test_torch_slice.py's tolerances: threshold decisions under
    # another summation order, at most 2 per frame in few frames; poses
    # over the first chunk to 1e-3
    for name in ("num_inliers", "num_map_matches"):
        d = np.abs(getattr(got, name).astype(int)
                   - getattr(ref, name).astype(int))
        assert d.max() <= 2 and (d > 0).sum() <= 2, name
    np.testing.assert_allclose(got.R, ref.R, atol=1e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=1e-3)
    assert (got.num_assoc_covis == 0).all()
    assert res.num_keyframes == NF_CHUNKED and res.num_rejected == 0
    assert res.ate_m < 1.0, res
