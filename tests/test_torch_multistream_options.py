"""The tracker options on the stream axis: each stream of a multi-stream
chunk against its own single-stream chunk, in the port.

Two streams (tests/test_torch_slice.py's 240x320 scene at seeds 11 and
12, N = 128, the committed tiny float32 weights, BA off), bootstrapped one
by one through ChunkedPipeline and stacked, then one chunk of 8 through
`build_multistream_chunk_fn` and, per stream, through `build_chunk_fn` on
the same draws, for each option that rides the stream axis: the merged
and batched re-observation modes (the batched mode's set axis of 2
behind the stream axis), the PnP tracker (per-stream Gumbel draws) and the
pair sub-pixel head (kspair_tiny.npz; the carried patches on the stream
axis).

Each stream equals the same stream run alone on the stream axis (a batch
of one) bit for bit: no operation mixes streams. Against the unbatched
single-stream chunk: every count equal and poses to 1e-3 (float32
batched products sum in another order than unbatched ones;
tests/test_torch_multistream.py measured 3.9e-4 m), except under the PnP
tracker, whose DLT hypotheses (an inverse iteration on 12x12 normal
equations) move with that order enough to flip points on the inlier
gate: there frame_ok is equal, map-match counts within 4 (measured 4, at
one frame of stream 0) and translations within 5e-2 m (the whole-run
bound of tests/test_torch_slice.py; tests/test_torch_pnp_tracker.py
finds a ~2 cm parting of the same kind between the packages).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gl_slam_tpu_torch import config as t_config
from gl_slam_tpu_torch.io import synthetic
from gl_slam_tpu_torch.slam import frontend, fused
from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline
from gl_slam_tpu_torch.slam.loopclose import pnp_draws
from gl_slam_tpu_torch.train import e2e

import test_torch_slice as ts_mod

# Small shapes: one ATen thread per test worker keeps the parallel suite
# from oversubscribing the cores.
torch.set_num_threads(1)

S, T = 2, ts_mod.CHUNK
H, W, N, D = ts_mod.H, ts_mod.W, ts_mod.N, t_config.TINY_DESC_DIM

OPTIONS = {
    "merged": (dict(reobs_mode="merged"), {}, False),
    "batched": (dict(reobs_mode="batched"), {}, False),
    "pnp": ({}, dict(tracker="pnp"), False),
    "pair-head": ({}, {}, True),
}


def _stack(states):
    """Single-stream states stacked on a leading stream axis."""
    return type(states[0])(*(
        None if x is None else
        type(x)(*(torch.stack([getattr(s.map, f) for s in states])
                  for f in x._fields)) if isinstance(x, tuple)
        else torch.stack([getattr(s, n) for s in states])
        for n, x in zip(states[0]._fields, states[0])))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_rides_the_stream_axis(option):
    map_kw, rt_kw, pair = OPTIONS[option]
    cfg = t_config.micro_config(H, W, N, D)
    cfg = dataclasses.replace(
        cfg, map=dataclasses.replace(cfg.map, **map_kw),
        runtime=dataclasses.replace(cfg.runtime, run_full_ba=False,
                                    loop_closing=False, **rt_kw))
    sp, lg = e2e.load_tiny_frontend(ts_mod.CKPT, device="cpu",
                                    dtype=torch.float32)
    head = e2e.load_tiny_subpix(ts_mod.CKPT, pair=True, device="cpu",
                                dtype=torch.float32) if pair else None
    scenes = [synthetic.make_scene(num_landmarks=900, num_frames=2 + T,
                                   height=H, width=W, desc_dim=D,
                                   seed=11 + s) for s in range(S)]
    stacks = [e2e.render_stack(sc, 2 + T, N) for sc in scenes]
    states = []
    for sc, st in zip(scenes, stacks):
        p = ChunkedPipeline(cfg, sc.K, sp, lg, chunk=T, device="cpu",
                            subpix_head=head)
        c = [-sc.poses_R[i].T @ sc.poses_t[i] for i in (0, 1)]
        p.bootstrap_from_images(st[0], st[1],
                                float(np.linalg.norm(c[1] - c[0])))
        states.append(p.state)
    g = torch.Generator().manual_seed(3)
    use_pnp = cfg.runtime.tracker == "pnp"
    u = None if use_pnp else torch.rand(
        (S, T, cfg.geometry.essential_hypotheses, 8), generator=g)
    gum = pnp_draws(g, (S, T, cfg.geometry.pnp_hypotheses, N)) \
        if use_pnp else None
    images = torch.from_numpy(np.stack([st[2:] for st in stacks]))
    fn = fused.build_multistream_chunk_fn(cfg, sp, lg, scenes[0].K, T, S,
                                          subpix_head=head)
    st_b, outs_b, _ = fn(_stack(states), images, 2, u, pnp_gumbel=gum)
    single = fused.build_chunk_fn(cfg, sp, lg, torch.as_tensor(
        scenes[0].K, dtype=torch.float32), T, subpix_head=head)
    alone = fused.build_multistream_chunk_fn(cfg, sp, lg, scenes[0].K, T, 1,
                                             subpix_head=head)
    for s in range(S):
        one = slice(s, s + 1)
        _, outs_a, _ = alone(_stack([states[s]]), images[one], 2,
                             None if u is None else u[one],
                             pnp_gumbel=None if gum is None else gum[one])
        for a, b in zip(outs_a, outs_b):
            for x, y in zip(a, b):
                assert torch.equal(x[0], y[s]), (option, s)
        st1, outs1, _ = single(states[s], images[s], 2,
                               None if u is None else u[s],
                               pnp_gumbel=None if gum is None else gum[s])
        for a, b in zip(outs1, outs_b):
            assert torch.equal(a.frame_ok, b.frame_ok[s])
            if use_pnp:
                assert abs(int(a.num_map_matches)
                           - int(b.num_map_matches[s])) <= 4
                torch.testing.assert_close(a.t, b.t[s], atol=5e-2, rtol=0)
                continue
            for name, x, y in zip(frontend.TrackOutputs._fields, a, b):
                if not x.is_floating_point():
                    assert torch.equal(x, y[s]), (option, s, name)
            torch.testing.assert_close(a.R, b.R[s], atol=1e-3, rtol=0)
            torch.testing.assert_close(a.t, b.t[s], atol=1e-3, rtol=0)
        assert bool(torch.stack([o.frame_ok for o in outs1]).all())
        assert int(st1.map.num_kf) == int(st_b.map.num_kf[s]) == 2 + T
        if pair:
            assert st_b.prev_patches.shape[0] == S
            torch.testing.assert_close(st1.prev_patches,
                                       st_b.prev_patches[s])
