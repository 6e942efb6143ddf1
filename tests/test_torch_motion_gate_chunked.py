"""Motion-gated keyframing on the chunked learned tracker: the port
against JAX.

Under `every_frame_keyframe=False` a rejected frame is routine, and the
next frame of the chunk finds its precomputed pair stale (matched against
the rejected frame): it takes the recovery branch, mutual nearest
neighbours against the carried last-accepted features and the essential
RANSAC on the prologue's draws for that frame (`prologue_recovery`, the
JAX default in this mode). The JAX ChunkedPipeline and the port's
(run_learned_e2e) track tests/test_torch_slice.py's 240x320 scene with BA
off: the filters at 1e6 (no frame kept after the bootstrap; every frame
but a chunk's first recovers) over one chunk of 8, and
test_torch_motion_gate.py's every-third-frame filter over two. The
`frame_ok` sequences and the recovery-branch frames equal JAX's, and the
poses agree within that file's tolerances.
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
from test_torch_motion_gate import KEEP_THIRD
import jax_weights

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

NF_CHUNKED = 2 + 2 * ts_mod.CHUNK
CHUNK_CASES = {
    "none": (dict(gt_mag_filter=1e6, gt_rot_filter=1e6), 2 + ts_mod.CHUNK),
    "every-third": (KEEP_THIRD, NF_CHUNKED),
}


def _recovery_frames(frame_ok, chunk):
    """The frames whose precomputed pair is stale: those after a rejected
    frame within a chunk (the first of a chunk pairs with the carried
    state)."""
    return [2 + i for i in range(1, len(frame_ok))
            if i % chunk and not frame_ok[i - 1]]


@pytest.fixture(scope="module", params=list(CHUNK_CASES))
def chunked(request):
    """One chunked run per case on each side, BA off: (JAX outputs, port
    outputs, port E2EResult, port diagnostics, frames)."""
    runtime, nf = CHUNK_CASES[request.param]
    scene, stack, scale = ts_mod._scene()

    def gated(cfg):
        return dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, every_frame_keyframe=False, **runtime))

    sp, spp, lg, lgp = jax_weights.load_tiny_frontend(ts_mod.CKPT)
    jcfg = gated(ts_mod._backend(j_e2e.micro_config(
        ts_mod.H, ts_mod.W, ts_mod.N, j_e2e.TINY_DESC_DIM), False))
    jp = JChunked(jcfg, jnp.asarray(scene.K, jnp.float32),
                  sp.clone(dtype=jnp.float32), lg.clone(dtype=jnp.float32),
                  j_fused.FusedParams(sp=spp, lg=lgp), chunk=ts_mod.CHUNK,
                  enable_ba=False)
    jp.bootstrap_from_images(stack[0], stack[1], scale)
    for s in range(2, nf, ts_mod.CHUNK):
        jp.track_chunk(jnp.asarray(stack[s:s + ts_mod.CHUNK]), s)

    feed, pos = ts_mod._jax_draws(jcfg)
    tsp, tlg = t_e2e.load_tiny_frontend(ts_mod.CKPT, device="cpu",
                                        dtype=torch.float32)
    tcfg = gated(ts_mod._backend(t_config.micro_config(
        ts_mod.H, ts_mod.W, ts_mod.N, t_config.TINY_DESC_DIM), False))
    diag = {}
    res = t_e2e.run_learned_e2e(tsp, tlg, scene, tcfg, nf,
                                chunk=ts_mod.CHUNK, device="cpu", draws=feed,
                                stack=stack[:nf], diag_out=diag)
    # the recovery branch reuses its frame's prologue draws
    assert pos[0] == nf - 1
    return jp.stacked_outputs(), diag["outputs"], res, diag, nf


def test_chunked_motion_gate_matches_jax(chunked):
    ref, got, res, diag, nf = chunked
    ok = np.asarray(ref.frame_ok)
    np.testing.assert_array_equal(got.frame_ok, ok)
    assert diag["recovery_frames"] == _recovery_frames(ok, ts_mod.CHUNK)
    assert diag["recovery_frames"]             # the branch ran
    np.testing.assert_array_equal(got.num_matches, ref.num_matches)
    # tests/test_torch_slice.py's tolerances (threshold decisions under
    # another summation order, at most 2 per frame in few frames), on the
    # pairs whose geometry is well posed: with the filters at 1e6 every
    # frame pairs with frame 1, and from ~4 m apart the 240x320 frames
    # share too few true matches for the RANSAC (JAX's reference keeps
    # 2-23 inliers of 53-65 matches there), whose verdict on such a pair
    # any rounding may change
    posed = ref.num_inliers >= ref.num_matches // 2
    assert posed.sum() >= 3
    for name in ("num_inliers", "num_map_matches"):
        d = np.abs(getattr(got, name).astype(int)
                   - getattr(ref, name).astype(int))[posed]
        assert d.max() <= 2 and (d > 0).sum() <= 2, name
    # that file's whole-run tolerances. Its tighter first-chunk bound on t
    # (1e-3) does not carry over: a kept frame here lies 3 m from the last
    # one and its pose rests on the points of 3 m baselines, so the
    # float32 differences grow ~3x faster per keyframe (measured 1.2e-3 m
    # at the first chunk's last kept frame, with every count equal)
    np.testing.assert_allclose(got.R, ref.R, atol=1e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=5e-2)
    # routine rejections roll nothing back
    assert diag["num_recoveries"] == 0
    assert res.num_keyframes == 2 + int(ok.sum())
    assert res.num_rejected == int((~ok).sum()) > 0
    for name in ("R", "t"):
        assert np.isfinite(diag[name]).all()
