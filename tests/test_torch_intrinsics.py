"""Distinct intrinsics per stream: K (S, 3, 3) on the stream axis.

KITTI's sequences come with three calibrations, so streams batched
together may each have their own camera. Three scenes (seeds 11, 12 and
13 of tests/test_torch_multistream.py's 240x320 set, N = 128, the
committed tiny weights, BA off) each get a K of their own, with f moved
by +1, -2 and +3 % and the principal point by -1, +2 and -3 %
(`scene._replace(K=...)`, so the rendered frames and the observations
follow it). Each stream is bootstrapped by itself with its
own K, then one chunk of 4 runs on the stream axis on each stream's JAX
key recurrence draws:

  * against JAX's `build_multistream_chunk_fn` with the same (S, 3, 3) K
    (vmapped into its chunk): tests/test_torch_multistream.py's
    tolerances: frame_ok and pass-1 match counts equal, inlier
    and map-match counts within 2 in at most 3 frames, rotations to 1e-3,
    translations to 5e-2 m;
  * against three single-stream chunks, each with its own (3, 3) K: every
    count equal, poses to 1e-3 (the stream axis sums float32 products in
    another order, as there);
  * a K whose rows are all equal gives the bits of the (3, 3) K shared by
    the streams, in every output and in the final state;
  * a device list of three entries splits K with the stream axis: each
    part equals its stream of the one-device run (counts, poses to 1e-3).

MultiStreamTracker with per-stream cameras is held to JAX's in
tests/test_torch_multistream_tracker.py, where the JAX tracker's compiled
programs are already built.
"""

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
from gl_slam_tpu_torch.parallel import mesh
from gl_slam_tpu_torch.slam import frontend as t_frontend
from gl_slam_tpu_torch.slam import fused as t_fused
from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline
from gl_slam_tpu_torch.train import e2e as t_e2e

import test_torch_slice as ts_mod
import jax_weights

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

S, T = 3, 4
H, W, N = ts_mod.H, ts_mod.W, ts_mod.N
D = j_e2e.TINY_DESC_DIM
F_MOVE = (0.01, -0.02, 0.03)       # relative change of fx and fy
C_MOVE = (-0.01, 0.02, -0.03)      # relative change of cx and cy


def _camera(K, s):
    K = np.array(K, np.float64)
    K[0, 0] *= 1 + F_MOVE[s]
    K[1, 1] *= 1 + F_MOVE[s]
    K[0, 2] *= 1 + C_MOVE[s]
    K[1, 2] *= 1 + C_MOVE[s]
    return K


def _chunk_draws(key, hyp):
    """The JAX chunk's per-frame RANSAC draws from a stream's key."""
    out = []
    for _ in range(T):
        key, k_ess, _ = jax.random.split(key, 3)
        out.append(np.asarray(jax.random.uniform(k_ess, (hyp, 8))))
    return torch.from_numpy(np.stack(out))


def _stack_tree(trees, stack):
    return type(trees[0])(*(
        None if x is None else
        _stack_tree([getattr(t, f) for t in trees], stack)
        if isinstance(x, tuple) else stack([getattr(t, f) for t in trees])
        for f, x in zip(trees[0]._fields, trees[0])))


def _outputs(outs):
    """Port per-frame outputs -> TrackOutputs of numpy (T, S) arrays."""
    return t_frontend.TrackOutputs(*(torch.stack(list(xs)).numpy()
                                     for xs in zip(*outs)))


@pytest.fixture(scope="module")
def setup():
    base = [synthetic.make_scene(num_landmarks=900, num_frames=2 + T,
                                 height=H, width=W, desc_dim=D, seed=11 + s)
            for s in range(S)]
    scenes = [sc._replace(K=_camera(sc.K, s))
              for s, sc in enumerate(base)]
    Ks = np.stack([sc.K for sc in scenes]).astype(np.float32)
    assert len({K.tobytes() for K in Ks}) == S
    stacks = [t_e2e.render_stack(sc, 2 + T, N) for sc in scenes]
    sp, spp, lg, lgp = jax_weights.load_tiny_frontend(ts_mod.CKPT)
    sp, lg = sp.clone(dtype=jnp.float32), lg.clone(dtype=jnp.float32)
    params = j_fused.FusedParams(sp=spp, lg=lgp)
    tsp, tlg = t_e2e.load_tiny_frontend(ts_mod.CKPT, device="cpu",
                                        dtype=torch.float32)
    jcfg = ts_mod._backend(j_e2e.micro_config(H, W, N, D), False)
    tcfg = ts_mod._backend(t_config.micro_config(H, W, N, D), False)
    jstates, tstates, draws = [], [], []
    for sc, st, K in zip(scenes, stacks, Ks):
        c0 = -sc.poses_R[0].T @ sc.poses_t[0]
        c1 = -sc.poses_R[1].T @ sc.poses_t[1]
        scale = float(np.linalg.norm(c1 - c0))
        jp = JChunked(jcfg, jnp.asarray(K), sp, lg, params, chunk=T,
                      enable_ba=False)
        jp.bootstrap_from_images(st[0], st[1], scale)
        feed, _ = ts_mod._jax_draws(jcfg)
        tp = ChunkedPipeline(tcfg, K, tsp, tlg, chunk=T, device="cpu",
                             enable_ba=False, draws=feed)
        tp.bootstrap_from_images(st[0], st[1], scale)
        jstates.append(jp.state)
        tstates.append(tp.state)
        draws.append(_chunk_draws(jp.state.key,
                                  jcfg.geometry.essential_hypotheses))
    c = dict(Ks=Ks, jcfg=jcfg, tcfg=tcfg, nets=(sp, lg, tsp, tlg),
             params=params, jstates=jstates, tstates=tstates,
             u=torch.stack(draws),
             images=np.stack([st[2:2 + T] for st in stacks]))
    c["port"] = _port_run(c, torch.from_numpy(Ks))
    return c


def _port_run(c, K, devices=None):
    _, _, tsp, tlg = c["nets"]
    fn = t_fused.build_multistream_chunk_fn(c["tcfg"], tsp, tlg, K, T, S,
                                            devices=devices)
    st = _stack_tree(c["tstates"], torch.stack)
    if devices is not None:
        st = mesh.shard_streams(st, devices)
    return fn(st, torch.from_numpy(c["images"]), 2, c["u"])


def test_distinct_intrinsics_chunk_matches_jax(setup):
    c = setup
    sp, lg, _, _ = c["nets"]
    fn = j_fused.build_multistream_chunk_fn(c["jcfg"], sp, lg,
                                            jnp.asarray(c["Ks"]), T, S)
    _, jouts = fn(c["params"], _stack_tree(c["jstates"], jnp.stack),
                  jnp.asarray(c["images"]), jnp.asarray(2, jnp.int32))
    ref = t_frontend.TrackOutputs(*(np.asarray(x).swapaxes(0, 1)
                                    for x in jouts))
    st, outs, rec = c["port"]
    got = _outputs(outs)
    np.testing.assert_array_equal(got.frame_ok, ref.frame_ok)
    np.testing.assert_array_equal(got.num_matches, ref.num_matches)
    for s in range(S):
        for name in ("num_inliers", "num_map_matches"):
            d = np.abs(getattr(got, name)[:, s].astype(int)
                       - getattr(ref, name)[:, s].astype(int))
            assert d.max() <= 2 and (d > 0).sum() <= 3, (s, name)
    np.testing.assert_allclose(got.R, ref.R, atol=1e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=5e-2)
    assert got.frame_ok.all() and not np.any(rec)
    np.testing.assert_array_equal(st.map.num_kf.numpy(), [2 + T] * S)


def test_distinct_intrinsics_chunk_equals_single_streams(setup):
    c = setup
    st, outs, _ = c["port"]
    got = _outputs(outs)
    _, _, tsp, tlg = c["nets"]
    for s in range(S):
        single = t_fused.build_chunk_fn(c["tcfg"], tsp, tlg,
                                        torch.from_numpy(c["Ks"][s]), T)
        st1, outs1, _ = single(c["tstates"][s],
                               torch.from_numpy(c["images"][s]), 2,
                               c["u"][s])
        one = _outputs(outs1)
        for name in t_frontend.TrackOutputs._fields:
            a, b = getattr(one, name), getattr(got, name)[:, s]
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_allclose(one.R, got.R[:, s], atol=1e-3)
        np.testing.assert_allclose(one.t, got.t[:, s], atol=1e-3)
        assert int(st1.map.num_pts) == int(st.map.num_pts[s])


def _leaves(tree):
    for x in tree:
        if isinstance(x, tuple):
            yield from _leaves(x)
        elif x is not None:
            yield x


def test_equal_rows_give_the_bits_of_a_shared_K(setup):
    c = setup
    K0 = torch.from_numpy(c["Ks"][0])
    shared = _port_run(c, K0)
    rows = _port_run(c, K0.expand(S, 3, 3).contiguous())
    for a, b in zip(_leaves(shared[0]), _leaves(rows[0])):
        assert torch.equal(a, b)
    for oa, ob in zip(shared[1], rows[1]):
        for a, b in zip(oa, ob):
            assert torch.equal(a, b)


def test_device_list_splits_K_with_the_streams(setup):
    """Under a device list of three entries (one stream a part) each part
    runs with its own stream's K: counts equal to the one-device run,
    poses to 1e-3 (tests/test_torch_multistream.py's device-list bound)."""
    c = setup
    st1, outs1, _ = c["port"]
    parts, outs3, _ = _port_run(c, torch.from_numpy(c["Ks"]),
                                devices=["cpu"] * S)
    assert len(parts) == S
    for p in range(S):
        got = _outputs(outs3[p])
        one = _outputs(outs1)
        for name in ("frame_ok", "num_matches", "num_inliers",
                     "num_map_matches"):
            np.testing.assert_array_equal(getattr(got, name)[:, 0],
                                          getattr(one, name)[:, p])
        np.testing.assert_allclose(got.t[:, 0], one.t[:, p], atol=1e-3)
        np.testing.assert_allclose(parts[p].map.kf_t[0].numpy(),
                                   st1.map.kf_t[p].numpy(), atol=1e-3)
