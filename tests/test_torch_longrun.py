"""The port's long-run harness (scripts/longrun_learned_torch.py) on the
CPU, against the JAX package.

  * the script's tiny branch against scripts/longrun_learned.py's, run
    through gl_slam_tpu.train.e2e.run_learned_e2e with the same scene and
    configuration edits, on the same RANSAC draws, over 38 frames in
    chunks of 4 with a 512-point table: the table turns over (more than
    twice its capacity in new points) in both, and the frames, keyframes
    and BA runs are equal, total_new_points within 2 % and the ATE within
    0.05 m (of ~36 m; 0.7007 against 0.6959 m here). The networks run in
    float32 in both packages, as the other parity tests build them: in
    bfloat16 the two round differently and part from the first frame, and
    a table this small starves between recycling passes, which makes the
    ATE of two such runs differ several-fold. Two edits beyond the
    script's flags, in both packages, make so small a table possible: the
    BA window and the covisibility set are cut to 256 points (a top-k over
    the table must fit in it), and the recycling ages to 21 keyframes, one
    past the map-match window, so that eviction under pressure
    (`recycle_stale_age`) frees healthy points inside the run;
  * the script's report: JAX's keys, and the card, wall time, peak memory,
    loop detections and per-segment lines;
  * `run_learned_e2e(render_cache=)` writes the rendered stack, then reads
    the same stack back instead of rendering;
  * `run_learned_e2e(warmup=True)` gives the trajectory of `warmup=False`,
    bit for bit.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gl_slam_tpu.config import MapConfig as JMapConfig
from gl_slam_tpu.io import synthetic as j_synthetic
from gl_slam_tpu.train import e2e as j_e2e
from gl_slam_tpu_torch.train import e2e

import jax_weights

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import longrun_learned_torch as longrun  # noqa: E402

torch.set_num_threads(1)

CKPT = os.path.join(ROOT, "checkpoints")
FRAMES, CHUNK, MAX_POINTS, AGE, WINDOW = 38, 4, 512, 21, 256
ARGV = ["--frames", str(FRAMES), "--chunk", str(CHUNK), "--ba-every",
        str(CHUNK), "--max-points", str(MAX_POINTS), "--weights", CKPT,
        "--device", "cpu"]


def _small_table(cfg):
    """The two edits beyond the script's flags (see the top), for a config
    of either package."""
    return dataclasses.replace(
        cfg, ba=dataclasses.replace(cfg.ba, max_window_points=WINDOW),
        map=dataclasses.replace(cfg.map, covis_max_points=WINDOW,
                                recycle_min_age=AGE, recycle_stale_age=AGE))


def _essential_draws(hyp, n):
    """The JAX driver's RANSAC draws: bootstrap `split(key)`, then
    `split(key, 3)` per frame."""
    key, k_ess = jax.random.split(jax.random.PRNGKey(0))
    draws = [np.asarray(jax.random.uniform(k_ess, (hyp, 8)))]
    for _ in range(n - 2):
        key, k_ess, _ = jax.random.split(key, 3)
        draws.append(np.asarray(jax.random.uniform(k_ess, (hyp, 8))))
    pos = [0]

    def feed(k):
        out = np.stack(draws[pos[0]:pos[0] + k])
        pos[0] += k
        return torch.from_numpy(out)

    return feed


def _jax_tiny(n, max_points):
    """scripts/longrun_learned.py's tiny branch (its defaults: 240 x 320,
    256 keypoints, seed 11), with the edits of `_small_table`."""
    H, W, N, D = 240, 320, 256, j_e2e.TINY_DESC_DIM
    sp, spp, lg, lgp = jax_weights.load_tiny_frontend(CKPT)
    sp, lg = sp.clone(dtype=jnp.float32), lg.clone(dtype=jnp.float32)
    scene = j_synthetic.make_scene(
        num_landmarks=max(1500, (n + 120) * 16), num_frames=n, height=H,
        width=W, desc_dim=D, seed=11, min_depth=4.0)
    cfg = j_e2e.micro_config(H, W, N, D)
    cfg = dataclasses.replace(
        cfg, geometry=dataclasses.replace(cfg.geometry, max_depth=60.0),
        map=JMapConfig(max_keyframes=max(128, 1 << (n - 1).bit_length()),
                       max_points=max_points, covis_max_points=512,
                       covis_edge_threshold=10))
    cfg = _small_table(cfg)
    return j_e2e.run_learned_e2e(sp, spp, lg, lgp, scene, cfg, n_frames=n,
                                 chunk=CHUNK, ba_every=CHUNK), cfg


@pytest.fixture(scope="module")
def runs():
    args = longrun.parse_args(ARGV)
    _, _, _, scene, cfg, run = longrun.setup(args)
    sp, lg = e2e.load_tiny_frontend(CKPT, device="cpu", dtype=torch.float32)
    cfg = _small_table(cfg)
    diag = {}
    ours = e2e.run_learned_e2e(
        sp, lg, scene, cfg, n_frames=FRAMES, device="cpu", diag_out=diag,
        draws=_essential_draws(cfg.geometry.essential_hypotheses, FRAMES),
        **run)
    ref, ref_cfg = _jax_tiny(FRAMES, MAX_POINTS)
    return ours, diag, cfg, ref, ref_cfg


def test_tiny_branch_turns_the_table_over_like_jax(runs):
    ours, diag, cfg, ref, ref_cfg = runs
    assert cfg.map.max_points == ref_cfg.map.max_points == MAX_POINTS
    for r in (ours, ref):
        assert r.num_frames == FRAMES and r.num_keyframes == FRAMES, r
        # tests/test_longrun.py's turnover bounds
        assert r.total_new_points > 1.5 * MAX_POINTS, r
        assert MAX_POINTS <= 0.5 * r.total_new_points, r
    assert ours.num_keyframes == ref.num_keyframes
    assert ours.num_ba_runs == ref.num_ba_runs
    assert ours.num_rejected == ref.num_rejected == 0
    assert abs(ours.total_new_points - ref.total_new_points) \
        <= 0.02 * ref.total_new_points, (ours, ref)
    assert abs(ours.ate_m - ref.ate_m) <= 0.05, (ours, ref)


def test_tiny_branch_evicts_under_pressure(runs):
    """Slots of healthy points (not culled) were freed: the eviction
    branch of state.recycle_free_slots ran inside the tracked run."""
    _, diag, _, _, _ = runs
    m = diag["state"].map
    assert int(m.free_count) + (m.capacity_pts - int(m.num_pts)) > 0
    assert int((m.pts_freed & ~m.pts_bad).sum()) > 0


def test_script_report_keys(tmp_path, capsys):
    out = tmp_path / "longrun.json"
    assert longrun.main(["--frames", "14", "--chunk", "6", "--ba-every",
                         "6", "--weights", CKPT, "--device", "cpu",
                         "--out", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rep = json.loads(out.read_text())
    assert printed == rep
    jax_keys = {"frames", "keyframes", "ate_rmse_m", "trajectory_len_m",
                "drift_pct", "fps_steady", "ba_runs", "mean_matches",
                "max_points_capacity", "total_new_points", "loop_closures",
                "reobs"}
    assert jax_keys <= set(rep)
    assert rep["card"] == "cpu" and rep["peak_allocated_gb"] is None
    assert rep["frames"] == 14 and rep["loop_detections"] == 0
    assert rep["wall_s"] > 0 and rep["segments"] == []


@pytest.fixture(scope="module")
def cached_runs(tmp_path_factory):
    """Two runs of the script's tiny set-up over 14 frames: the first
    renders and writes `render_cache`, the second reads it (rendering
    raises) and warms up first. ((result, diag, stack on disk after the
    first run) of the first, (result, diag) of the second, the set-up)."""
    args = longrun.parse_args(["--frames", "14", "--weights", CKPT,
                               "--device", "cpu"])
    sp, lg, _, scene, cfg, _ = longrun.setup(args)
    cache = str(tmp_path_factory.mktemp("cache") / "stack.npy")

    def run(**kw):
        diag = {}
        res = e2e.run_learned_e2e(sp, lg, scene, cfg, n_frames=14, chunk=6,
                                  ba_every=6, device="cpu", diag_out=diag,
                                  render_cache=cache, **kw)
        return res, diag

    first = run() + (np.load(cache),)

    def no_render(*a, **k):
        raise AssertionError("rendered although the cache exists")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(e2e, "render_stack", no_render)
        second = run(warmup=True)
        with pytest.raises(ValueError, match="fewer than"):
            e2e.run_learned_e2e(sp, lg, scene, cfg, n_frames=20, chunk=6,
                                device="cpu", render_cache=cache)
    return first, second, (scene, cfg)


def test_render_cache_writes_then_reads_the_stack(cached_runs):
    (_, _, on_disk), _, (scene, cfg) = cached_runs
    np.testing.assert_array_equal(
        on_disk, e2e.render_stack(scene, 14, cfg.frontend.max_keypoints))


def test_warmup_leaves_the_trajectory_as_it_was(cached_runs):
    """The second run read the first run's stack (equal to a fresh render,
    above) and warmed up: its trajectory is the first's, bit for bit."""
    (cold, d_cold, _), (warm, d_warm), _ = cached_runs
    np.testing.assert_array_equal(d_cold["R"], d_warm["R"])
    np.testing.assert_array_equal(d_cold["t"], d_warm["t"])
    np.testing.assert_array_equal(d_cold["outputs"].num_matches,
                                  d_warm["outputs"].num_matches)
    assert cold.num_ba_runs == warm.num_ba_runs
    assert cold.total_new_points == warm.total_new_points
