"""One run of a cell: set-up, the measured window, the check.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name: `configs/<config>.json`,
`traffic/<traffic>.json` and `metrics/<metric>.py`, with the cell's
entry and the metric list in `BENCHMARK.json` at the root of the checkout.

The system under test is gl_slam_tpu_torch's batched multi-stream chunk:
S streams in lock step through `slam/fused.build_multistream_chunk_fn`,
each chunk of T frames followed by one window BA pass of every stream
(`parallel/multistream.MultiStreamTracker.ba`). The benchmark calls the
program only through its entry points (config, the weight loaders of
train/e2e, fused.build_extract_fn for the bootstrap's features,
build_multistream_chunk_fn, MultiStreamTracker, ops/_build.build_all).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from typing import Callable, Optional

import numpy as np

from . import check, scene

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "gl_slam_tpu")


class SetupError(RuntimeError):
    """The cell cannot run here (no card, too few cards, a missing file)."""


# ---------------------------------------------------------------------------
# Finding a cell's files by name

def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_json: Optional[str] = None,
              bench_dir: str = BENCH_DIR) -> dict:
    """The cell `workload` of BENCHMARK.json, with its configuration and
    traffic files and the metrics it reports."""
    bench_json = bench_json or os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(bench_json):
        raise SetupError(f"{bench_json} not found")
    bj = _read_json(bench_json)
    cells = [w for w in bj["workloads"] if w["name"] == workload]
    if not cells:
        raise SetupError(f"no workload {workload!r} in {bench_json}")
    cell = cells[0]
    cfg = _read_json(os.path.join(bench_dir, "configs",
                                  f"{cell['config']}.json"))
    traffic = _read_json(os.path.join(bench_dir, "traffic",
                                      f"{cell['traffic']}.json"))
    return dict(name=workload, cell=cell, config=cfg, traffic=traffic,
                end_to_end=[m for m in bj["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bj["per_layer"]
                           if _applies(m, workload)],
                bench_dir=bench_dir)


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """`read(ctx)` of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"_bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# The program's configuration and networks

def slam_config(cfg_file: dict):
    """The port's SLAMConfig: flagship_config() at the file's image size,
    with every other `pipeline` key set on the section that has the
    field."""
    from gl_slam_tpu_torch import config as port_cfg
    p = dict(cfg_file["pipeline"])
    nets = cfg_file["networks"]
    if p["preset"] != "flagship":
        raise SetupError(f"unknown preset {p['preset']!r}")
    cfg = port_cfg.flagship_config(p["image_height"], p["image_width"])
    sections = {f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(cfg)}
    changes: dict = {}
    for key, value in p.items():
        if key == "preset":
            continue
        owners = [s for s, sec in sections.items()
                  if key in {f.name for f in dataclasses.fields(sec)}]
        if len(owners) != 1:
            raise SetupError(f"pipeline key {key!r} names {len(owners)} "
                             f"config fields")
        changes.setdefault(owners[0], {})[key] = value
    cfg = dataclasses.replace(cfg, **{
        s: dataclasses.replace(sections[s], **kv)
        for s, kv in changes.items()})
    if cfg.frontend.descriptor_dim != nets["descriptor_dim"]:
        raise SetupError("descriptor width of the pipeline and the networks "
                         "differ")
    return cfg


def load_networks(cfg_file: dict, device):
    """The program's networks with the committed weights: (sp, lg, pair
    head), in the configuration's compute dtype."""
    import torch
    from gl_slam_tpu_torch.train import e2e
    nets = cfg_file["networks"]
    ckpt = os.path.join(ROOT, "checkpoints")
    dtype = getattr(torch, nets["dtype"])
    if nets["weights"] != "flagship":
        raise SetupError(f"unknown weights {nets['weights']!r}")
    sp, lg = e2e.load_flagship_frontend(ckpt, device=device, dtype=dtype)
    head = e2e.load_flagship_subpix(ckpt, pair=True, device=device,
                                    dtype=dtype)
    if head is None:
        raise SetupError("the pair head's checkpoint is missing")
    return sp, lg, head


def weight_paths(cfg_file: dict) -> dict:
    tag = cfg_file["networks"]["weights"]
    ckpt = os.path.join(ROOT, "checkpoints")
    return {k: os.path.join(ckpt, f"{k}_{tag}.npz")
            for k in ("sp", "lg", "kspair")}


def require_program(cfg_file: dict) -> None:
    """The checkout holds the program and the configuration's weights."""
    if not os.path.isdir(os.path.join(ROOT, "gl_slam_tpu_torch")):
        raise SetupError(f"no gl_slam_tpu_torch package in {ROOT}")
    for path in weight_paths(cfg_file).values():
        if not os.path.exists(path):
            raise SetupError(f"{path} not found")


def stream_seed(seed: int, s: int) -> int:
    """Stream s's generator seed, mixed from (seed, s)."""
    st = np.random.SeedSequence([int(seed), int(s)]).generate_state(
        2, np.uint64)
    return int(st[0]) & ((1 << 63) - 1)


# ---------------------------------------------------------------------------
# The drive

class Drive:
    """S streams around one lap of the circle. Stream s starts at frame
    floor(F s / S) and reads frame (start + k) mod F at its k-th frame;
    frames 0 and 1 bootstrap it, and chunk c covers its frames 2 + T c to
    1 + T (c + 1)."""

    def __init__(self, cell: dict, seed: int, device):
        import torch
        p, tr = cell["config"]["pipeline"], cell["traffic"]
        self.S, self.T = tr["streams"], tr["chunk"]
        self.F = tr["loop_period"]
        self.scene = scene.loop_scene(seed, self.F, tr["landmarks_per_frame"],
                                      p["image_height"], p["image_width"])
        self.frames = scene.render_frames_torch(
            self.scene, range(self.F), p["max_keypoints"], device,
            params=scene.blob_params_cached(len(self.scene.landmarks),
                                            CACHE_DIR))
        self.starts = (self.F * np.arange(self.S)) // self.S
        self.starts_dev = torch.as_tensor(self.starts, device=device)
        self.offsets = torch.arange(self.T, device=device)

    def scene_frame(self, s: int, k: int) -> int:
        return int((self.starts[s] + k) % self.F)

    def chunk_images(self, c: int):
        """(S, T, H, W) images of chunk c, gathered on the card."""
        first = 2 + self.T * c
        idx = (self.starts_dev[:, None] + first + self.offsets) % self.F
        return self.frames[idx]

    def gt_center(self, s: int, k: np.ndarray) -> np.ndarray:
        """Camera centres of stream s's frames k in the stream's own frame
        (its frame 0 at the origin, as the tracker's bootstrap sets it)."""
        sc = self.scene
        f0 = self.scene_frame(s, 0)
        R0, t0 = sc.poses_R[f0], sc.poses_t[f0]
        c0 = -R0.T @ t0
        f = (self.starts[s] + np.asarray(k)) % self.F
        c = -np.einsum("kji,kj->ki", sc.poses_R[f], sc.poses_t[f])
        return (c - c0) @ R0.T

    def bootstrap_scale(self, s: int) -> float:
        c = self.gt_center(s, np.array([0, 1]))
        return float(np.linalg.norm(c[1] - c[0]))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else f"nvidia-smi exit {out.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def forbidden_modules() -> list:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# The map arrays of the sampled streams copied around each BA pass: the
# pass's input (everything the window problem is made of) and what the
# pass writes.
PRE_BA = ("num_kf", "kf_R", "kf_t", "kf_kpts", "kf_kp2mp", "kf_kp_valid",
          "pts_xyz", "pts_valid", "pts_bad", "pts_first_kf", "pts_obs_kf",
          "pts_obs_kp")
POST_BA = ("kf_R", "kf_t", "pts_xyz")


class Program:
    """The system under test, set up for a cell: kernels built, networks
    loaded, S streams bootstrapped (frames 0 and 1 of each, matched by the
    learned matcher) and one warm-up chunk and BA pass run. Around every
    BA pass the map arrays of the check's sampled streams are copied on
    the card (`ba_input`, `ba_output`), without a read by the host."""

    def __init__(self, cell: dict, drive: Drive, seed: int, device):
        import torch
        from gl_slam_tpu_torch.ops import _build
        from gl_slam_tpu_torch.parallel.multistream import \
            MultiStreamTracker
        from gl_slam_tpu_torch.slam import fused
        if device.type == "cuda":
            _build.build_all()
        self.cfg = slam_config(cell["config"])
        self.sp, self.lg, self.head = load_networks(cell["config"], device)
        S, T = drive.S, drive.T
        self.drive, self.S, self.T = drive, S, T
        K = drive.scene.K
        self.hyp = self.cfg.geometry.essential_hypotheses
        self.gens = [torch.Generator(device=device).manual_seed(
            stream_seed(seed, s)) for s in range(S)]
        self.sample = check.sample_streams(
            seed, S, cell["traffic"]["check_streams"])
        self._sample_dev = torch.as_tensor(self.sample, device=device)
        self.ba_input: dict = {}
        self.ba_output: dict = {}
        self.tracker = MultiStreamTracker(self.cfg, K, S, device=device)
        self.fn = fused.build_multistream_chunk_fn(
            self.cfg, self.sp, self.lg, K, T, S, subpix_head=self.head)
        self.window_kf = T + self.cfg.ba.full_ba_overlap
        self.ba_every = cell["traffic"]["ba_every"]
        if self.ba_every % T:
            raise SetupError(f"ba_every {self.ba_every} is not a whole "
                             f"number of chunks of {T}")
        with torch.no_grad():
            self._bootstrap(drive, device)
        self.outputs: list = []
        self.chunks = 0
        self.step()                     # the warm-up chunk and BA pass

    def _bootstrap(self, drive: Drive, device):
        """Each stream's frames 0 and 1, extracted in groups of streams,
        matched and bootstrapped."""
        import torch
        from gl_slam_tpu_torch.slam import frontend, fused
        S, T = self.S, self.T
        extract = fused.build_extract_fn(self.cfg, self.sp,
                                         subpix_head=self.head)
        f0, f1 = [], []
        group = max(1, T // 2)
        for a in range(0, S, group):
            ss = range(a, min(S, a + group))
            idx = [drive.scene_frame(s, k) for s in ss for k in (0, 1)]
            out = extract(drive.frames[idx])
            f0.append([x[0::2] for x in out])
            f1.append([x[1::2] for x in out])
        f0 = [torch.cat(xs) for xs in zip(*f0)]
        f1 = [torch.cat(xs) for xs in zip(*f1)]
        # the bootstrap pair matched by the learned matcher, as the
        # single-stream pipeline bootstraps (ChunkedPipeline.
        # bootstrap_from_images); MultiStreamTracker.bootstrap matches it by
        # mutual nearest neighbours and leaves about one stream in 32-64
        # with a metre-sized error by its first chunk (PERF.md)
        i32 = torch.int32
        fa = frontend.FrameFeatures(*f0[:3], torch.zeros(S, dtype=i32,
                                                          device=device))
        fb = frontend.FrameFeatures(*f1[:3], torch.ones(S, dtype=i32,
                                                         device=device))
        m = fused.build_matcher(self.cfg, self.lg)(*f0[:3], *f1[:3])
        scales = torch.tensor([drive.bootstrap_scale(s) for s in range(S)],
                              dtype=torch.float32, device=device)
        u = torch.stack([torch.rand((self.hyp, 8), generator=g,
                                    device=device) for g in self.gens])
        K_dev = torch.as_tensor(drive.scene.K, dtype=torch.float32,
                                device=device)
        self.tracker.state, _ = frontend.bootstrap_step(
            self.cfg, K_dev, self.tracker.state, fa, fb, scales, matches=m,
            u=u, patches1=f1[3])

    def _sampled(self, fields) -> dict:
        m = self.tracker.state.map
        return {k: getattr(m, k).index_select(0, self._sample_dev)
                for k in fields}

    def draws(self):
        import torch
        return torch.stack([torch.rand((self.T, self.hyp, 8), generator=g,
                                       device=g.device) for g in self.gens])

    def step(self):
        """One chunk of every stream, then one window BA pass of every
        stream when `ba_every` frames have passed."""
        import torch
        from torch.profiler import record_function
        c = self.chunks
        images = self.drive.chunk_images(c)
        u = self.draws()
        with record_function("bench.chunk"):
            st, outs, _ = self.fn(self.tracker.state, images, 2 + self.T * c,
                                  u)
        self.tracker.state = st
        if ((c + 1) * self.T) % self.ba_every == 0:
            nk = st.map.num_kf
            first = torch.clamp_min(nk - self.window_kf, 0)
            self.ba_input = self._sampled(PRE_BA)
            with record_function("bench.ba"):
                self.tracker.ba(first, nk - first)
            self.ba_output = self._sampled(POST_BA)
        self.outputs.append((torch.stack([o.R for o in outs], 1),
                             torch.stack([o.t for o in outs], 1),
                             torch.stack([o.frame_ok for o in outs], 1)))
        self.chunks += 1
