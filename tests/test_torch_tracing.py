"""Tracing, state checkpoints and the live viewer of the per-frame route.

`StageTimer` and `MetricsRecorder` against the JAX package's on the same
records; `save_state` -> `load_state` bit for bit, and a run resumed from
the loaded state against the uninterrupted run; `LiveViewer` streaming
`live.json` through atomic renames. The tracked state comes from the
port's TrackingPipeline (oracle features of tests/test_tracking.py's
scene, BA off, on the CPU).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gl_slam_tpu import tracing as j_tracing
from gl_slam_tpu_torch import checkpoint, tracing
from gl_slam_tpu_torch import config as t_config
from gl_slam_tpu_torch.io import synthetic
from gl_slam_tpu_torch.slam import frontend
from gl_slam_tpu_torch.slam.pipeline import TrackingPipeline
from gl_slam_tpu_torch.viz import viewer

torch.set_num_threads(1)

H, W, N, D, NF = 240, 320, 256, 64, 8


def _cfg():
    c = t_config
    return c.SLAMConfig(
        frontend=c.FrontendConfig(image_height=H, image_width=W,
                                  max_keypoints=N, descriptor_dim=D),
        geometry=c.GeometryConfig(essential_hypotheses=128,
                                  essential_refine_iters=5,
                                  triangulation_reproj_px=0.5),
        ba=c.BAConfig(max_window_cameras=12, max_window_points=2048,
                      full_ba_iters=15, pose_only_iters=15),
        map=c.MapConfig(max_keyframes=64, max_points=8192,
                        covis_max_points=256, covis_edge_threshold=10))


@pytest.fixture(scope="module")
def tracked():
    """(pipeline after frames 0..NF-2, observations 0..NF-1, scene)."""
    scene = synthetic.make_scene(num_landmarks=3000, num_frames=NF, height=H,
                                 width=W, desc_dim=D, seed=42)
    obs = [synthetic.observe_frame(scene, i, max_keypoints=N, seed=9)
           for i in range(NF)]
    pipe = TrackingPipeline(_cfg(), scene.K, enable_ba=False, device="cpu")
    c0 = -scene.poses_R[0].T @ scene.poses_t[0]
    c1 = -scene.poses_R[1].T @ scene.poses_t[1]
    pipe.bootstrap((obs[0].keypoints, obs[0].descriptors, obs[0].valid, 0),
                   (obs[1].keypoints, obs[1].descriptors, obs[1].valid, 1),
                   gt_scale=float(np.linalg.norm(c1 - c0)))
    for i in range(2, NF - 1):
        pipe.step(obs[i].keypoints, obs[i].descriptors, obs[i].valid, i)
    return pipe, obs, scene


def test_metrics_recorder_writes_what_jax_writes(tmp_path):
    rows = [(3, dict(num_matches=torch.tensor(120, dtype=torch.int32),
                     ratio=torch.tensor(0.25), tag="a")),
            (4, dict(num_matches=7, ratio=0.5, tag=None))]
    t, j = tracing.MetricsRecorder(), j_tracing.MetricsRecorder()
    for i, kv in rows:
        t.record(i, **kv)
        j.record(i, **{k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v
                       for k, v in kv.items()})
    t.to_jsonl(str(tmp_path / "t.jsonl"))
    j.to_jsonl(str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    assert t.last() == j.last() == {"frame": 4, "num_matches": 7.0,
                                    "ratio": 0.5, "tag": None}
    assert tracing.MetricsRecorder().last() is None


def test_stage_timer_summary_like_jax():
    """Same keys, counts and rounding; a CPU `sync_on` is never waited
    on."""
    t, j = tracing.StageTimer(block=True), j_tracing.StageTimer()
    for timer in (t, j):
        for name in ("track", "features", "track"):
            with timer.stage(name, sync_on=torch.zeros(1)):
                pass
    st, sj = t.summary(), j.summary()
    assert list(st) == list(sj) == ["features", "track"]
    for k in st:
        assert set(st[k]) == set(sj[k]) == {"total_s", "mean_ms", "count"}
        assert st[k]["count"] == sj[k]["count"]
        assert st[k]["total_s"] >= 0.0


def test_profiler_trace_exports_a_chrome_trace(tmp_path):
    with tracing.profiler_trace(str(tmp_path)) as prof:
        torch.ones(4).sum()
    assert prof is not None
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def _leaves(state, prefix=""):
    for name, v in state._asdict().items():
        if hasattr(v, "_asdict"):
            yield from _leaves(v, prefix + name + ".")
        else:
            yield prefix + name, v


def test_save_and_load_state_bit_for_bit(tracked, tmp_path):
    pipe, _, _ = tracked
    checkpoint.save_state(str(tmp_path / "ckpt"), pipe.state)
    like = frontend.init_track_state(pipe.cfg, device="cpu")
    got = checkpoint.load_state(str(tmp_path / "ckpt"), like)
    assert type(got) is type(pipe.state) and type(got.map) is \
        type(pipe.state.map)
    assert got.map.pts_desc.dtype == torch.bfloat16
    for (name, a), (_, b) in zip(_leaves(got), _leaves(pipe.state)):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.device == b.device, name
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), name
    # the map alone round-trips too
    checkpoint.save_state(str(tmp_path / "map"), pipe.state.map)
    m = checkpoint.load_state(str(tmp_path / "map"), like.map)
    assert torch.equal(m.kf_R, pipe.state.map.kf_R)


def test_load_state_rejects_a_mismatch(tracked, tmp_path):
    pipe, _, _ = tracked
    path = str(tmp_path / "ckpt")
    checkpoint.save_state(path, pipe.state)
    small = pipe.cfg.replace(map=t_config.MapConfig(
        max_keyframes=32, max_points=8192, covis_max_points=256,
        covis_edge_threshold=10))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_state(path, frontend.init_track_state(small,
                                                              device="cpu"))
    with pytest.raises(ValueError, match="fields differ"):
        checkpoint.load_state(path, frontend.init_track_state(
            pipe.cfg, device="cpu", patch=7))
    with pytest.raises(ValueError, match="fields differ"):
        checkpoint.load_state(path, pipe.state.map)


def test_resumed_run_takes_the_same_next_step(tracked, tmp_path):
    """The step after a save/load round trip equals the step of the run
    that went on, bit for bit (the same draws)."""
    pipe, obs, scene = tracked
    checkpoint.save_state(str(tmp_path / "ckpt"), pipe.state)
    resumed = checkpoint.load_state(
        str(tmp_path / "ckpt"), frontend.init_track_state(pipe.cfg,
                                                          device="cpu"))
    o = obs[NF - 1]
    f = frontend.FrameFeatures(
        torch.from_numpy(np.asarray(o.keypoints, np.float32)),
        torch.from_numpy(np.asarray(o.descriptors, np.float32)),
        torch.from_numpy(np.asarray(o.valid)),
        torch.tensor(NF - 1, dtype=torch.int32))
    u = torch.rand((128, 8), generator=torch.Generator().manual_seed(5))
    K = torch.from_numpy(np.asarray(scene.K, np.float32))
    with torch.no_grad():
        s1, o1 = frontend.track_step(pipe.cfg, K, pipe.state, f, u)
        s2, o2 = frontend.track_step(pipe.cfg, K, resumed, f, u)
    assert bool(o1.frame_ok) and int(o1.num_map_matches) > 50
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)
    for (name, a), (_, b) in zip(_leaves(s1), _leaves(s2)):
        assert (a is None and b is None) or torch.equal(a, b), name


def test_live_viewer_streams_through_atomic_renames(tracked, tmp_path,
                                                    monkeypatch):
    pipe, _, _ = tracked
    out = str(tmp_path / "live")
    renames = []
    replace = os.replace

    def spy(src, dst):
        assert os.path.exists(src) and os.path.basename(src).startswith(".")
        renames.append((os.path.basename(src), os.path.basename(dst)))
        replace(src, dst)

    monkeypatch.setattr(viewer.os, "replace", spy)
    live = viewer.LiveViewer(out, every=2)
    for i in range(5):                     # exports at updates 2 and 4
        live.update(pipe.state.map, 10 + i)
    live.close()
    assert not live._thread.is_alive()
    assert 1 <= live.num_renders <= 2      # a pending snapshot may be dropped
    assert live.last_frame == 13           # never the newest one
    assert (".live.json.tmp", "live.json") in renames
    png = viewer.render_topdown(viewer.MapSnapshot(pipe.state.map),
                                str(tmp_path / "probe.png"))
    assert ((".tmp.live.png", "live.png") in renames) == png
    assert sorted(n for n in os.listdir(out) if n.startswith(".")) == []
    with open(os.path.join(out, "live.json")) as f:
        snap = json.load(f)
    want = viewer.MapSnapshot(pipe.state.map)
    assert len(snap["keyframe_centers"]) == len(want.centers) == NF - 1
    np.testing.assert_allclose(snap["points"], want.points)
