"""Tracing, state checkpoints and the live viewer of the per-frame route.

`MetricsRecorder` and the recorder's `stages` against the JAX package's
MetricsRecorder and StageTimer on the same records; the span API off, on
and under a CPU `torch.profiler` (the shared clock), its Chrome export,
and the host-read funnel on a 2-stream chunk; `save_state` ->
`load_state` bit for bit, and a run resumed from the loaded state against
the uninterrupted run; `LiveViewer` streaming `live.json` through atomic
renames. The tracked state comes from the port's TrackingPipeline (oracle
features of tests/test_tracking.py's scene, BA off, on the CPU).
"""

import json
import os
import time

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


def _spans(names, wait_s=0.0):
    """Open the spans of `names` in turn, each around a short wait."""
    for name in names:
        with tracing.span(name):
            time.sleep(wait_s)


def test_recorder_stages_like_jax_stage_timer():
    """The command line's `stages` have the JAX StageTimer's keys, order,
    counts and rounding."""
    j = j_tracing.StageTimer()
    names = ("track", "features", "track")
    for name in names:
        with j.stage(name):
            time.sleep(0.001)
    with tracing.recording() as rec:
        _spans(names, 0.001)
    st, sj = rec.stages(), j.summary()
    assert list(st) == list(sj) == ["features", "track"]
    for k in st:
        assert set(st[k]) == set(sj[k]) == {"total_s", "mean_ms", "count"}
        assert st[k]["count"] == sj[k]["count"]
        assert st[k]["total_s"] == round(st[k]["total_s"], 4) >= 0.001
        assert st[k]["mean_ms"] == round(st[k]["mean_ms"], 3) >= 1.0
    assert list(rec.stages(("track",))) == ["track"]


def test_span_off_opens_no_range_and_reads_no_clock(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(tracing, "record_function", refuse)
    monkeypatch.setattr(tracing, "_clock", refuse)
    assert tracing.span("a") is tracing.span("b", streams=2, step=True) \
        is tracing.span("c", profile=False)
    with tracing.span("chunk", step=True):
        tracing.at_frame(3)
        with tracing.span("track"):
            pass
    assert tracing.host_read(torch.ones(2), "x.read").tolist() == [1, 1]
    assert tracing._REC is None


def test_spans_nest_with_parents_self_time_and_ids():
    with tracing.recording() as rec:
        with tracing.span("chunk", streams=2, step=True):
            with tracing.span("prologue"):
                time.sleep(0.002)
            with tracing.span("track"):
                for i in range(2):
                    tracing.at_frame(i)
                    with tracing.span("track.pose_lm"):
                        time.sleep(0.002)
                    tracing.host_read(torch.zeros(3), "track.host_read")
            time.sleep(0.002)
        with tracing.span("backend.ba", streams=2):
            pass
        with tracing.span("chunk", streams=2, step=True):
            pass
    r = rec.records
    assert [x.name for x in r] == [
        "chunk", "prologue", "track", "track.pose_lm", "track.host_read",
        "track.pose_lm", "track.host_read", "backend.ba", "chunk"]
    assert [r[x.parent].name if x.parent >= 0 else None for x in r] == [
        None, "chunk", "chunk", "track", "track", "track", "track", None,
        None]
    assert [x.step for x in r] == [0, 0, 0, 0, 0, 0, 0, 0, 1]
    assert [x.frame for x in r] == [None, None, None, 0, 0, 1, 1, None,
                                    None]
    assert all(x.streams == 2 for x in r)
    s = rec.summary()
    chunk = r[0]
    kids = sum(x.end_ns - x.start_ns for x in r if x.parent == 0)
    assert chunk.self_ns == chunk.end_ns - chunk.start_ns - kids
    assert chunk.self_ns >= 2e6                 # the last wait is its own
    assert s["track.pose_lm"]["calls"] == 2
    assert s["track.pose_lm"]["self_ms"] >= 4.0
    assert s["track.host_read"]["reads"] == 2
    assert s["track"]["reads"] == 0
    read = s["track.host_read"]
    assert read["blocked_ms"] > 0.0
    assert abs(read["self_ms"] + read["blocked_ms"] - read["wall_ms"]) < 1e-6
    assert s["chunk"]["calls"] == 2 and s["backend.ba"]["syncs"] == 0


def test_a_recording_inside_another_takes_its_region():
    """A nested recording() (the command line's, under a caller's) keeps
    the spans of its region; the outer one records again after it."""
    with tracing.recording() as outer:
        _spans(["a"])
        with tracing.recording(syncs=False) as inner:
            _spans(["b", "c"])
        _spans(["d"])
    assert tracing._REC is None
    assert [r.name for r in outer.records] == ["a", "d"]
    assert [r.name for r in inner.records] == ["b", "c"]
    assert list(inner.stages()) == ["b", "c"]


def _annotations(prof):
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def test_spans_share_the_profilers_clock():
    """Under a CPU torch.profiler each span is also a profiler range, and
    its recorded start and end lie within 0.2 ms of the range's. The
    profiler stamps a range in C++ a few tens of us from the span's clock
    read; a thread descheduled in between (the suite runs in parallel
    workers) stretches one such gap, so the profile is taken up to three
    times and one of them must hold for every span. A clock of another
    base would miss by years on every try."""
    from torch.profiler import ProfilerActivity, profile
    names = ["chunk", "prologue", "track", "track.pose_lm", "backend.ba"]
    misses = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracing.recording() as rec:
                _spans(names, 0.001)
                with tracing.span("bench.ba"):
                    with tracing.span("backend.ba", profile=False):
                        time.sleep(0.001)
        ranges = _annotations(prof)
        assert [n for n, _, _ in ranges] == names + ["bench.ba"]
        assert [r.name for r in rec.records] == names + ["bench.ba",
                                                         "backend.ba"]
        misses = [(name, r.start_ns - a, r.end_ns - b)
                  for (name, a, b), r in zip(ranges, rec.records)
                  if abs(r.start_ns - a) >= 2e5 or abs(r.end_ns - b) >= 2e5]
        if not misses:
            break
    assert not misses, misses


def test_export_loads_as_one_chrome_trace(tmp_path):
    """The recorder's export beside torch.profiler's own: one Chrome trace
    holding both, each span on the profiler's time base."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording() as rec:
            with tracing.span("chunk", streams=1, step=True):
                _spans(["track"], 0.001)
                torch.ones(4).sum()
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    rec.export(str(tmp_path / "both.json"), beside=str(tmp_path / "prof.json"))
    rec.export(str(tmp_path / "spans.json"))
    with open(tmp_path / "both.json") as f:
        both = json.load(f)
    with open(tmp_path / "spans.json") as f:
        alone = json.load(f)
    assert "traceEvents" in alone and "baseTimeNanoseconds" in alone
    ours = [e for e in both["traceEvents"] if e.get("cat") == "span"]
    theirs = {e["name"]: e for e in both["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert [e["name"] for e in ours] == ["chunk", "track"]
    assert set(theirs) >= {"chunk", "track"}
    assert ours[1]["args"]["parent"] == "chunk"
    assert ours[0]["args"]["step"] == 0 and ours[0]["args"]["streams"] == 1
    # the profiler's time base, on which its own ranges lie: the clock
    # itself is held to the ranges in test_spans_share_the_profilers_clock
    base = both["baseTimeNanoseconds"]
    with open(tmp_path / "prof.json") as f:
        assert json.load(f)["baseTimeNanoseconds"] == base
    for e, r in zip(ours, rec.records):
        assert e["ts"] == (r.start_ns - base) / 1e3
        assert e["dur"] == (r.end_ns - r.start_ns) / 1e3


@pytest.mark.parametrize("recovery", [True, False], ids=["recovery", "off"])
def test_chunk_reads_the_card_only_on_the_recovery_branch(recovery):
    """A 2-stream chunk of T frames (oracle features, mutual-NN matching,
    so no network runs): under `prologue_recovery` the previous verdict is
    read once a frame after the first, through the funnel
    (`track.host_read`); without it nothing is read. Every frame's spans
    carry their step and frame ids. Under a profiler the stages open
    their ranges, and the spans that hold them (`chunk`, `prologue`,
    `track`) open none, so a caller's range around the chunk keeps the
    kernels issued between the stages."""
    import types

    from torch.profiler import ProfilerActivity, profile

    from gl_slam_tpu_torch.parallel.multistream import MultiStreamTracker
    from gl_slam_tpu_torch.slam import fused

    T, S = 4, 2
    cfg = _cfg()
    scene = synthetic.make_scene(num_landmarks=3000, num_frames=2 + T,
                                 height=H, width=W, desc_dim=D, seed=42)
    obs = [synthetic.observe_frame(scene, i, max_keypoints=N, seed=9)
           for i in range(2 + T)]

    def stack(idx, attr, dtype):
        return torch.from_numpy(np.stack(
            [np.asarray(getattr(obs[i], attr)) for i in idx])).to(dtype)

    ms = MultiStreamTracker(cfg, scene.K, S, device="cpu")
    c = [-scene.poses_R[i].T @ scene.poses_t[i] for i in (0, 1)]
    ms.bootstrap(*[(np.stack([obs[i].keypoints] * S),
                    np.stack([obs[i].descriptors] * S),
                    np.stack([obs[i].valid] * S)) for i in (0, 1)],
                 [float(np.linalg.norm(c[1] - c[0]))] * S)
    fn = fused.build_chunk_fn(
        cfg, None, types.SimpleNamespace(dim=D),
        torch.as_tensor(scene.K, dtype=torch.float32), T,
        prologue_recovery=recovery, match_with_lightglue=False,
        reobs_with_lightglue=False)
    idx = range(2, 2 + T)
    feats = tuple(x.unsqueeze(0).expand((S,) + x.shape) for x in (
        stack(idx, "keypoints", torch.float32),
        stack(idx, "descriptors", torch.float32),
        stack(idx, "valid", torch.bool)))
    u = torch.rand((S, T, cfg.geometry.essential_hypotheses, 8),
                   generator=torch.Generator().manual_seed(3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording() as rec:
            with tracing.span("chunk", streams=S, step=True,
                              profile=False):
                _, outs, _ = fn(ms.state, None, 2, u, features=feats)
    assert bool(torch.stack([o.frame_ok for o in outs]).all())
    ranges = {name for name, _, _ in _annotations(prof)}
    assert {"prologue.match", "prologue.essential", "track.pose_lm"} \
        <= ranges
    assert not ranges & {"chunk", "prologue", "track"}
    assert ("track.host_read" in ranges) == recovery
    s = rec.summary()
    reads = [r for r in rec.records if r.name == "track.host_read"]
    if recovery:
        assert s["track.host_read"]["reads"] == T - 1
        assert [r.frame for r in reads] == list(range(1, T))
        assert {rec.records[r.parent].name for r in reads} == {"track"}
    else:
        assert not reads
    assert sum(v["reads"] for v in s.values()) == (T - 1 if recovery else 0)
    assert s["prologue"]["calls"] == s["track"]["calls"] == 1
    lm = [r for r in rec.records if r.name == "track.pose_lm"]
    assert sorted({r.frame for r in lm}) == list(range(T))
    assert all(r.step == 0 and r.streams == S for r in rec.records)


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
