"""The port's measurement entry points on the CPU, against the JAX ones.

  * bench_torch.py's configurations equal, field by field, bench.py's
    `dataclasses.replace` of the JAX package's `flagship_config`;
  * its schedules equal the ones bench.py's own `run_single` and
    `run_multi` issue: their code, read from bench.py through `ast`, runs
    here on stand-ins that log each chunk, BA pass and detection;
  * its cells at micro size (the tiny checkpoints, 240x320, N=128) give a
    JSON line with bench.py's keys (the dict literal of its last print),
    then the port's FLOP keys, with finite positive fps;
  * `frame_flops` within 1 % of `torch.utils.flop_counter` over one chunk
    of the plain path at micro size (the per-module counts exactly);
  * scripts/profile_stages_torch.py times every stage of
    scripts/profile_stages.py, scripts/microbench_ops_torch.py every op of
    scripts/microbench_ops.py, under the same names;
  * scripts/bench_diff_torch.py exits 1 on a stage 20 % slower, 0 within
    the tolerance;
  * the entry points raise without CUDA, and the bench without the trained
    flagship checkpoints;
  * the committed card records (BENCH_TORCH.json, PERF_BASELINE_TORCH.json)
    hold what the programs print.
"""

import ast
import dataclasses
import itertools
import json
import math
import os
import sys
import types

import pytest
import torch

from gl_slam_tpu.train import e2e as j_e2e

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path.insert(0, ROOT)
sys.path.insert(0, SCRIPTS)

import bench_diff_torch  # noqa: E402
import bench_torch as bt  # noqa: E402
import microbench_ops_torch  # noqa: E402
import profile_stages_torch  # noqa: E402
from gl_slam_tpu_torch.config import (TINY_LG, TINY_SP_CHANNELS,  # noqa: E402
                                      micro_config)

torch.set_num_threads(1)

CKPT = os.path.join(ROOT, "checkpoints")
H, W, N, D = 240, 320, 128, 64
CHUNK = 4


def _tree(name):
    path = os.path.join(ROOT, name)
    return path, ast.parse(open(path).read(), path)


def _main_of(tree):
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _call_names(tree, fn_name):
    """The string first arguments of every call of `fn_name`."""
    return [n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id == fn_name and n.args
            and isinstance(n.args[0], ast.Constant)]


# ---------------------------------------------------------------------------
# configurations and schedules

def _jax_variants():
    """bench.py:71-84, on the JAX package's flagship_config."""
    cfg = j_e2e.flagship_config(376, 1241)
    cfg_strict = dataclasses.replace(
        cfg,
        map=dataclasses.replace(cfg.map, covis_max_points=2048),
        geometry=dataclasses.replace(cfg.geometry,
                                     essential_hypotheses=512))
    cfg_merged = dataclasses.replace(
        cfg, map=dataclasses.replace(cfg.map, reobs_mode="merged"))
    cfg_batched = dataclasses.replace(
        cfg_strict, map=dataclasses.replace(cfg_strict.map,
                                            reobs_mode="batched"))
    return dict(relaxed=cfg, strict=cfg_strict, merged=cfg_merged,
                batched=cfg_batched)


@pytest.mark.parametrize("name", ["relaxed", "strict", "merged", "batched"])
def test_variants_equal_bench_py(name):
    from gl_slam_tpu_torch.config import flagship_config
    port = bt.variants(flagship_config(bt.H, bt.W))[name]
    ref = _jax_variants()[name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _bench_py_run(fn_name, *args):
    """Run bench.py's own `fn_name` (run_single / run_multi, nested in its
    main) on stand-ins -> (warm-up log, timed log): ("chunk", chunk tensor,
    frame index), ("ba", first, window), ("detect",), split at the clock
    reads."""
    path, tree = _tree("bench.py")
    node = next(n for n in ast.walk(_main_of(tree))
                if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    log, clock = [], itertools.count()

    def state():
        return types.SimpleNamespace(
            map=types.SimpleNamespace(num_kf=0), prev_kpts=None,
            prev_desc=None, prev_valid=None, R_cur=None, t_cur=None,
            _replace=lambda **kw: state())

    def chunk_fn(params, st, c, idx):
        log.append(("chunk", c, idx))
        return state(), None

    def perf_counter():
        log.append(("clock",))
        return float(next(clock))

    ns = dict(
        fused=types.SimpleNamespace(build_chunk_fn=lambda *a, **k: chunk_fn),
        cfg=None, sp=None, lg=None, K=None, ks_head=None,
        params=types.SimpleNamespace(lg=None),
        CHUNK=8, BA_EVERY=8, S=16, LOOP_EVERY=20, chunks=list(range(8)),
        jnp=types.SimpleNamespace(asarray=lambda x, dtype=None: int(x),
                                  int32=None),
        jax=types.SimpleNamespace(random=types.SimpleNamespace(
            PRNGKey=lambda s: ("key", s))),
        mkstate=lambda seed: state(),
        ba1=lambda m, first, win: log.append(("ba", first, win)),
        detect_fn=lambda *a: log.append(("detect",)),
        time=types.SimpleNamespace(perf_counter=perf_counter))
    exec(compile(ast.Module(body=[node], type_ignores=[]), path, "exec"), ns)
    ns[fn_name](*args)
    first = log.index(("clock",))
    last = len(log) - 1 - log[::-1].index(("clock",))
    return log[:first], log[first + 1:last]


@pytest.mark.parametrize("n", [8, 4, 3])
def test_single_schedule_is_bench_py(n):
    warm, timed = _bench_py_run("run_single", True, n)
    assert warm == [("chunk", bt.WARMUP_CHUNK, bt.WARMUP_FRAME),
                    ("ba",) + bt.WARMUP_BA, ("detect",)]
    ref = []
    for e in timed:
        if e[0] == "chunk":
            ref.append([e[1], e[2], None, False])
        elif e[0] == "ba":
            ref[-1][2] = e[1:]
        else:
            ref[-1][3] = True
    assert [tuple(r) for r in ref] == bt.single_schedule(n)
    if n == 8:           # the 8th timed chunk wraps back to chunk 0
        assert bt.single_schedule(n)[-1][:2] == (0, 2)


@pytest.mark.parametrize("n", [8, 4, 3])
def test_multi_schedule_is_bench_py(n):
    warm, timed = _bench_py_run("run_multi", n)
    assert warm == [("chunk", bt.WARMUP_CHUNK, bt.WARMUP_FRAME),
                    ("ba",) + bt.WARMUP_BA] * bt.S
    rounds = []
    for e in timed:
        if e[0] == "chunk":
            if not rounds or rounds[-1][1]:
                rounds.append(([], []))
            rounds[-1][0].append(e[1:])
        else:
            assert e[0] == "ba"
            rounds[-1][1].append(e[1:])
    ref = [[(c, f, bas[s] if bas else None, False)
            for s, (c, f) in enumerate(chunks)] for chunks, bas in rounds]
    assert ref == bt.multi_schedule(n, bt.S)


# ---------------------------------------------------------------------------
# the cells at micro size, and the FLOP count

@pytest.fixture(scope="module")
def micro():
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.train import e2e
    cfg = micro_config(H, W, N, D)
    assert cfg.runtime.loop_closing and cfg.runtime.run_full_ba
    cfgs = bt.variants(cfg)
    sp, lg = e2e.load_tiny_frontend(CKPT, device="cpu")
    ks = e2e.load_tiny_subpix(CKPT, pair=True, device="cpu")
    scene = synthetic.make_scene(num_landmarks=900, num_frames=2 + 2 * CHUNK,
                                 height=H, width=W, desc_dim=D, seed=0)
    b = bt.setup(cfgs["relaxed"], sp, lg, ks, scene, "cpu",
                 n_frames=2 * CHUNK, chunk=CHUNK)
    return cfgs, b


def test_cells_print_bench_py_line(micro, capsys):
    cfgs, b = micro
    cells = bt.run_cells(b, cfgs, single_chunks=1, multi_chunks=1,
                         streams=2)
    line = bt.result_line({k: fps for k, (fps, _) in cells.items()}, cfgs,
                          streams=2, flops_kw=dict(
                              sp_channels=TINY_SP_CHANNELS,
                              lg_shape=TINY_LG))
    bt.check_line(line)
    print(json.dumps(line))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _, tree = _tree("bench.py")
    lit = next(n.args[0].args[0] for n in ast.walk(_main_of(tree))
               if isinstance(n, ast.Call) and getattr(n.func, "id", "")
               == "print" and n.args and isinstance(n.args[0], ast.Call)
               and n.args[0].args and isinstance(n.args[0].args[0],
                                                 ast.Dict))
    keys = tuple(k.value for k in lit.keys)
    assert keys == bt.BENCH_KEYS
    assert tuple(printed) == keys + bt.FLOP_KEYS
    for key in keys + bt.FLOP_KEYS:
        if key.endswith("fps") or key in ("value",) + bt.FLOP_KEYS \
                or "roofline" in key:
            assert math.isfinite(printed[key]) and printed[key] > 0, key
    assert printed["streams"] == 2 and printed["ba_every_frames"] == 8
    # on the CPU no kernel launches
    assert all(v == 0 for _, launches in cells.values()
               for v in launches.values())


@pytest.mark.parametrize("variant,reobs_lg", [
    ("relaxed", True), ("strict", True), ("merged", True),
    ("batched", True), ("relaxed", False)])
def test_frame_flops_counts_the_plain_chunk(micro, variant, reobs_lg):
    """One chunk of CHUNK frames on the plain path under FlopCounterMode:
    SuperPointNet, LightGlueNet and the pair head count what
    `frame_flops`' parts say, and the total (the assignment's similarity
    and the geometry's small products included) is within 1 % of it."""
    from torch.utils.flop_counter import FlopCounterMode

    from gl_slam_tpu_torch.slam import fused
    cfgs, b = micro
    cfg = cfgs[variant]
    fn = fused.build_chunk_fn(cfg, b.sp, b.lg, b.K, CHUNK,
                              reobs_with_lightglue=reobs_lg,
                              subpix_head=b.ks)
    u = torch.rand((CHUNK, cfg.geometry.essential_hypotheses, 8),
                   generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as fc:
        fn(bt.mkstate(b), b.chunks[0], 2, u)
    per_module = {k: sum(v.values()) / CHUNK
                  for k, v in fc.get_flop_counts().items()}
    assert per_module["SuperPointNet"] == bt.superpoint_flops(
        H, W, TINY_SP_CHANNELS, D)
    assert per_module["PairSubpixHead"] == bt.pair_head_flops(N, D, 128, 7)
    want = bt.frame_flops(cfg, TINY_SP_CHANNELS, TINY_LG, reobs_lg=reobs_lg)
    got = fc.get_total_flops() / CHUNK
    assert abs(got / want - 1) < 0.01, (got, want)


def test_frame_flops_at_flagship():
    """The roofline fields: the strict frame near JAX's stated ~775 GFLOP,
    the relaxed one near its ~590 (bench.py:302-303), on the H100's
    989.4 TFLOP/s."""
    from gl_slam_tpu_torch.config import flagship_config
    cfgs = bt.variants(flagship_config(bt.H, bt.W))
    strict, relaxed = (bt.frame_flops(cfgs[k]) for k in ("strict",
                                                         "relaxed"))
    assert 0.9 < strict / 775e9 < 1.1 and 0.9 < relaxed / 590e9 < 1.1
    assert bt.frame_flops(cfgs["batched"]) == strict
    line = bt.result_line({k: 1.0 for k in bt.BENCH_KEYS
                           if k.endswith("fps") or k == "value"}, cfgs)
    assert line["strict_roofline_fps_at_100pct_mfu"] == round(
        989.4e12 / strict, 1)


# ---------------------------------------------------------------------------
# the stage profile, the guard and the microbench

def test_profile_stages_names_every_stage(monkeypatch):
    from gl_slam_tpu_torch.train import e2e
    monkeypatch.setattr(profile_stages_torch, "BLOCKS", 2)
    monkeypatch.setattr(profile_stages_torch, "MIN_BLOCK_S", 0.0)
    _, tree = _tree(os.path.join("scripts", "profile_stages.py"))
    names = _call_names(tree, "bench")
    assert len(names) == 15
    sp, lg = e2e.load_tiny_frontend(CKPT, device="cpu")
    stages = profile_stages_torch.run_stages(
        torch.device("cpu"), sp, lg, n=1, height=96, width=128,
        max_kpts=64, desc_dim=D, landmarks=300, ba_n=1)
    assert list(stages) == names
    rep = profile_stages_torch.report(stages, "cpu", "cpu")
    assert list(rep["stages_ms"]) == names
    assert all(math.isfinite(v) and v > 0 for v in rep["stages_ms"].values())
    assert all(r["device_ms"] is None and r["launches"] is None
               for r in stages.values())


def _stage_file(path, scale=1.0, card="NVIDIA H100 80GB HBM3, 700.00 W"):
    with open(path, "w") as f:
        json.dump({"backend": "cuda", "card": card, "stages_ms": {
            "superpoint CNN": 4.0 * scale, "track_step (oracle)": 500.0}},
            f)
    return str(path)


@pytest.mark.parametrize("scale,rc", [(1.2, 1), (1.1, 0), (0.5, 0)])
def test_bench_diff_flags_a_slower_stage(tmp_path, scale, rc):
    base = _stage_file(tmp_path / "base.json")
    cur = _stage_file(tmp_path / "cur.json", scale)
    assert bench_diff_torch.main([cur, "--baseline", base]) == rc
    # --update accepts the run as the new baseline
    assert bench_diff_torch.main([cur, "--baseline", base,
                                  "--update"]) == 0
    assert bench_diff_torch.main([cur, "--baseline", base]) == 0


def test_microbench_names_every_op(tmp_path):
    _, tree = _tree(os.path.join("scripts", "microbench_ops.py"))
    names = _call_names(tree, "bench")
    out = tmp_path / "ops.json"
    assert microbench_ops_torch.main(["--device", "cpu", "--n", "1",
                                      "--json", str(out)]) == 0
    rows = json.load(open(out))["ops"]
    assert list(rows) == names
    assert rows[names[0]]["above_floor_ms"] is None
    assert all(r["above_floor_ms"] is not None for r in
               list(rows.values())[1:])


# ---------------------------------------------------------------------------
# refusals and the committed records

def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bt.main, profile_stages_torch.main,
                 microbench_ops_torch.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    with pytest.raises(FileNotFoundError, match="sp_flagship.npz"):
        bt.main(["--device", "cpu", "--checkpoints", str(tmp_path)])


def test_committed_card_records():
    """BENCH_TORCH.json: the line bench_torch.py printed on the card;
    PERF_BASELINE_TORCH.json: the 15 stages measured there."""
    rec = json.load(open(os.path.join(ROOT, "BENCH_TORCH.json")))
    assert tuple(rec["line"]) == bt.BENCH_KEYS + bt.FLOP_KEYS
    bt.check_line(rec["line"])
    assert rec["line"]["weights"] == "trained-flagship"
    assert rec["card"].startswith("NVIDIA H100")
    base = json.load(open(os.path.join(ROOT, "PERF_BASELINE_TORCH.json")))
    _, tree = _tree(os.path.join("scripts", "profile_stages.py"))
    assert base["backend"] == "cuda" and base["card"].startswith(
        "NVIDIA H100")
    assert list(base["stages_ms"]) == _call_names(tree, "bench")
    assert all(r["launches"] > 0 and r["device_ms"] > 0
               for r in base["stages"].values())
