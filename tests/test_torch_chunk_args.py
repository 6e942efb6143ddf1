"""The chunk function's arguments: the port against JAX.

Each case builds both packages' `build_chunk_fn` with one argument set
and tracks one chunk of 8 of tests/test_torch_slice.py's 240x320 scene
(N = 128, the committed tiny weights, BA off) from the same bootstrap, on
the JAX key recurrence's RANSAC draws:

  * `prologue=False`: the serial layout, pass 1 by LightGlue in the
    per-frame loop, and without LightGlue by mutual nearest neighbours
    inside the step;
  * `match_with_lightglue=False`: a mutual-NN pass 1 in the prologue;
  * `reobs_with_lightglue=False`: mutual-NN re-observation passes against
    a configuration that asks for LightGlue;
  * `features=`: features extracted beforehand in place of the images
    (the port's run also equals its own image run bit for bit);
  * `prologue_recovery=True` under every-frame keyframing, with a frame of
    another scene in the chunk: it is rejected, the next frame takes the
    recovery branch (mutual NN against the carried features) and the
    chunk goes on;
  * `prologue_recovery=False` under motion-gated keyframing (keep every
    third frame): the first rejection rejects the rest of the chunk.

Tolerances are tests/test_torch_slice.py's first-chunk ones: frame_ok and
pass-1 match counts equal, inlier and map-match counts within 2 in at most
2 frames (threshold decisions under another summation order), poses to
1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu.io import synthetic
from gl_slam_tpu.slam import fused as j_fused
from gl_slam_tpu.slam.chunk_driver import ChunkedPipeline as JChunked
from gl_slam_tpu.train import e2e as j_e2e
from gl_slam_tpu_torch import config as t_config
from gl_slam_tpu_torch.slam import frontend as t_frontend
from gl_slam_tpu_torch.slam import fused as t_fused
from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline
from gl_slam_tpu_torch.train import e2e as t_e2e

import test_torch_slice as ts_mod
from test_torch_motion_gate import KEEP_THIRD
import jax_weights

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

T = ts_mod.CHUNK
FOREIGN = 3        # chunk position of the frame from another scene

CASES = {
    "serial": dict(prologue=False),
    "serial-mnn": dict(prologue=False, match_with_lightglue=False),
    "mnn-pass1": dict(match_with_lightglue=False),
    "reobs-mnn": dict(reobs_with_lightglue=False),
    "features": dict(),
    "recovery-on": dict(prologue_recovery=True),
    "recovery-off-gated": dict(prologue_recovery=False),
}


def _gated(cfg):
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, every_frame_keyframe=False, **KEEP_THIRD))


def _chunk_draws(key, hyp):
    """The JAX chunk's per-frame RANSAC draws from the state's key."""
    out = []
    for _ in range(T):
        key, k_ess, _ = jax.random.split(key, 3)
        out.append(np.asarray(jax.random.uniform(k_ess, (hyp, 8))))
    return torch.from_numpy(np.stack(out))


@pytest.fixture(scope="module")
def setup():
    scene, stack, scale = ts_mod._scene()
    other = synthetic.make_scene(num_landmarks=900, num_frames=4,
                                 height=ts_mod.H, width=ts_mod.W,
                                 desc_dim=j_e2e.TINY_DESC_DIM, seed=99)
    foreign = stack[2:2 + T].copy()
    foreign[FOREIGN] = t_e2e.render_stack(other, 4, ts_mod.N)[3]
    sp, spp, lg, lgp = jax_weights.load_tiny_frontend(ts_mod.CKPT)
    sp, lg = sp.clone(dtype=jnp.float32), lg.clone(dtype=jnp.float32)
    tsp, tlg = t_e2e.load_tiny_frontend(ts_mod.CKPT, device="cpu",
                                        dtype=torch.float32)
    # one bootstrap serves every case: the keyframe policy does not enter
    # the two-view bootstrap
    jcfg = ts_mod._backend(j_e2e.micro_config(
        ts_mod.H, ts_mod.W, ts_mod.N, j_e2e.TINY_DESC_DIM), False)
    tcfg = ts_mod._backend(t_config.micro_config(
        ts_mod.H, ts_mod.W, ts_mod.N, t_config.TINY_DESC_DIM), False)
    jp = JChunked(jcfg, jnp.asarray(scene.K, jnp.float32), sp, lg,
                  j_fused.FusedParams(sp=spp, lg=lgp), chunk=T,
                  enable_ba=False)
    jp.bootstrap_from_images(stack[0], stack[1], scale)
    feed, _ = ts_mod._jax_draws(jcfg)
    tp = ChunkedPipeline(tcfg, scene.K, tsp, tlg, chunk=T, device="cpu",
                         enable_ba=False, draws=feed)
    tp.bootstrap_from_images(stack[0], stack[1], scale)
    return scene, stack, foreign, (sp, lg, tsp, tlg), (jcfg, tcfg, jp, tp)


def _run(setup, case):
    scene, stack, foreign, (sp, lg, tsp, tlg), (jcfg, tcfg, jp, tp) = setup
    args = CASES[case]
    if case == "recovery-off-gated":
        jcfg, tcfg = _gated(jcfg), _gated(tcfg)
    images = foreign if case == "recovery-on" else stack[2:2 + T]
    K = jnp.asarray(scene.K, jnp.float32)
    jfn = j_fused.build_chunk_fn(jcfg, sp, lg, K, T, **args)
    jstate = jax.tree_util.tree_map(jnp.copy, jp.state)
    tfn = t_fused.build_chunk_fn(tcfg, tsp, tlg, tp.K, T, **args)
    u = _chunk_draws(jp.state.key, jcfg.geometry.essential_hypotheses)
    if case == "features":
        jfeats = jp.extract_fn(jp.params, jnp.asarray(images))
        _, jouts = jfn(jp.params, jstate, None, jnp.asarray(2, jnp.int32),
                       features=jfeats)
        tfeats = tp.extract_fn(torch.from_numpy(images))
        tstate, touts, rec = tfn(tp.state, None, 2, u, features=tfeats)
        ist, iouts, _ = tfn(tp.state, torch.from_numpy(images), 2, u)
        for a, b in zip(touts, iouts):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        assert torch.equal(tstate.map.pts_xyz, ist.map.pts_xyz)
    else:
        _, jouts = jfn(jp.params, jstate, jnp.asarray(images),
                       jnp.asarray(2, jnp.int32))
        tstate, touts, rec = tfn(tp.state, torch.from_numpy(images), 2, u)
    ref = t_frontend.TrackOutputs(*(np.asarray(x) for x in jouts))
    got = t_frontend.TrackOutputs(*(torch.stack(list(xs)).numpy()
                                    for xs in zip(*touts)))
    return ref, got, rec


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_argument_matches_jax(setup, case):
    ref, got, rec = _run(setup, case)
    ok = np.asarray(ref.frame_ok)
    np.testing.assert_array_equal(got.frame_ok, ok)
    np.testing.assert_array_equal(got.num_matches, ref.num_matches)
    for name in ("num_inliers", "num_map_matches"):
        d = np.abs(getattr(got, name).astype(int)
                   - getattr(ref, name).astype(int))
        assert d.max() <= 2 and (d > 0).sum() <= 2, name
    np.testing.assert_allclose(got.R, ref.R, atol=1e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=1e-3)
    if case == "recovery-on":
        # the foreign frame is rejected, the next one recovers and is kept
        assert not ok[FOREIGN] and ok[FOREIGN + 1]
        assert rec == [i == FOREIGN + 1 for i in range(T)]
    elif case == "recovery-off-gated":
        # the first rejection rejects the rest of the chunk
        first = int(np.argmin(ok))
        assert not ok[first] and not ok[first:].any() and ok[:first].all()
        assert not any(rec)
    else:
        assert ok.all() and not any(rec)


def test_pair_head_refuses_the_serial_layout():
    cfg = t_config.micro_config(ts_mod.H, ts_mod.W, ts_mod.N,
                                t_config.TINY_DESC_DIM)
    from gl_slam_tpu_torch.models.subpix import PairSubpixHead
    with pytest.raises(ValueError, match="prologue=True"):
        t_fused.build_chunk_fn(cfg, None, None, torch.eye(3), T,
                               subpix_head=PairSubpixHead(
                                   desc_dim=t_config.TINY_DESC_DIM),
                               prologue=False)
