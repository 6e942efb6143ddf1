"""Benchmark: tracked frames/sec on one card, the flagship learned pipeline
of the PyTorch/CUDA port (gl_slam_tpu_torch).

The port of `bench.py`, with its setup, schedule and JSON keys. Headline
metric = single-stream throughput of the FULL learned pipeline per frame
at STRICT reference parity (trained flagship weights): 1x SuperPoint-style
extraction (376x1241, N=2048) through the NMS kernel + sub-pixel
refinement, 3x LightGlue-style attention matching (attention and
assignment kernels) with fixed-2048 re-observation sets (prev<->cur,
map-window set, covisibility set), the learned pair sub-pixel head,
essential RANSAC, pose-only LM(30), triangulation, map insertion, a window
BA (<= 30 LM iterations) after every chunk of 8 frames and a learned
loop-detection pass every 20 frames, all INSIDE the timed loop.

Also in the same JSON line, as in `bench.py`:
  * the relaxed operating point (`flagship_config()`: re-observation sets
    capped at 1024, 256 RANSAC hypotheses), the configuration of the
    flagship eval;
  * the strict shapes with both re-observation passes as one batch-2
    matcher call (`reobs_mode="batched"`) and the relaxed one with one
    merged candidate pool (`reobs_mode="merged"`);
  * single-stream fps with mutual-NN re-observation passes (the cheap
    configuration);
  * the 16-stream aggregate (BASELINE configs[4]) of time-multiplexed
    single-stream chunks on the one card.

Frames: the 66 frames of `make_scene(num_landmarks=14000, num_frames=66,
seed=0)`, rendered once (cached under the temporary directory) and staged
on the card as 8 chunk tensors before any timing. Each timed chunk is a
distinct slice of the 64-frame stream, but at 8 timed chunks the last one
wraps back to chunk 0 (`bench.py:179`); the wrap is kept, since it belongs
to the workload the JAX record was taken on. As in `bench.py`, the
tracking state starts from an empty map with the previous-frame features
set to frame 1's oracle observation, and each window BA pass replaces the
map alone (`bench.py:144-145`).

Draws: each cell's RANSAC draws come from a `torch.Generator` on the device
seeded 0 (stream s of the multi-stream cell: seeded s, as `mkstate(s)`);
the loop detector's Gumbel draws are one fixed tensor, seeded 7 (JAX's
`PRNGKey(7)`).

The roofline fields are the port's own count: `frame_flops` (the matmul
and convolution FLOPs of one tracked frame, from the shapes) on the H100
SXM's dense bf16 peak. Prints the card line and each cell's kernel
launches (`ops/_build.LAUNCHES` over its timed window) on earlier lines,
then ONE JSON line. vs_baseline is against the 500 tracked frames/sec
north star of BASELINE.json.

    python3 bench_torch.py                      # on the card, ~6-8 min
    python3 bench_torch.py --out BENCH_TORCH.json
    python3 bench_torch.py --ms-econ            # MS_ECON_TORCH.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))

H, W, N, D = 376, 1241, 2048, 256
CHUNK = 8
S = 16                      # streams per card (BASELINE configs[4])
BA_EVERY = 8                # frames between BA passes (~ reference cadence 7)
N_FRAMES = 64               # distinct timed frames (+2 before them)
LANDMARKS = 14000
DETECT_SEED = 7
NORTH_STAR_FPS = 500.0      # BASELINE.json
# NVIDIA H100 SXM data sheet: 989.4 TFLOP/s dense bf16 on the tensor cores
# (no sparsity), at its 700 W limit.
H100_BF16_PEAK_FLOPS = 989.4e12

METRIC = ("tracked frames/sec/chip (full learned pipeline, strict "
          "reference parity: 1x SuperPoint + 3x LightGlue with "
          "fixed-2048 re-obs sets + pair-subpix head + RANSAC + "
          "pose-LM30 + windowed BA30 in-loop + learned "
          "loop-detection pass every 20 frames, KITTI 376x1241, "
          "N=2048; every timed frame is a distinct rendered image "
          "of a continuous 64-frame stream, staged on the card)")
# The keys of bench.py's JSON line, in its order, then the port's own.
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "weights",
              "relaxed_reobs1024_fps", "strict_batched_reobs_fps",
              "merged_reobs_fps", "single_stream_mutualnn_reobs_fps",
              "multistream_aggregate_fps", "streams", "ba_every_frames",
              "strict_roofline_fps_at_100pct_mfu",
              "relaxed_roofline_fps_at_100pct_mfu")
FLOP_KEYS = ("flops_per_frame_strict", "flops_per_frame_relaxed")
# The single-stream cells in bench.py's order: (key of the line, variant,
# LightGlue re-observation passes, timed chunks). `value` is the strict one.
SINGLE_CELLS = (("relaxed_reobs1024_fps", "relaxed", True, 8),
                ("value", "strict", True, 4),
                ("strict_batched_reobs_fps", "batched", True, 4),
                ("merged_reobs_fps", "merged", True, 8),
                ("single_stream_mutualnn_reobs_fps", "relaxed", False, 8))
MULTI_KEY, MULTI_CHUNKS = "multistream_aggregate_fps", 3


def variants(cfg) -> dict:
    """The configurations of `bench.py:72-87`: relaxed (`cfg` itself),
    strict (2048-point re-observation sets, 512 RANSAC hypotheses), merged
    (relaxed, one merged candidate pool) and batched (strict, both passes
    as one batch-2 matcher call)."""
    rep = dataclasses.replace
    strict = rep(cfg, map=rep(cfg.map, covis_max_points=2048),
                 geometry=rep(cfg.geometry, essential_hypotheses=512))
    return dict(relaxed=cfg, strict=strict,
                merged=rep(cfg, map=rep(cfg.map, reobs_mode="merged")),
                batched=rep(strict, map=rep(strict.map,
                                            reobs_mode="batched")))


# ---------------------------------------------------------------------------
# Schedules (bench.py:160-240)

def single_schedule(n_chunks: int, n_stream_chunks: int = N_FRAMES // CHUNK,
                    chunk: int = CHUNK, ba_every: int = BA_EVERY,
                    loop_every: int = 20) -> list:
    """The timed loop of `run_single`: per timed chunk i, (chunk tensor,
    its first frame index, the BA pass after it as (first, window) or None,
    whether a loop detection is issued after it). Chunk i runs chunk
    tensor (i + 1) % n_stream_chunks; a detection is issued whenever
    `loop_every` frames have passed since the last one."""
    out, since = [], 0
    for i in range(n_chunks):
        c = (i + 1) % n_stream_chunks
        ba = (max(2 + i * chunk - 3, 0), chunk + 3) \
            if (i * chunk) % ba_every == 0 else None
        since += chunk
        det = since >= loop_every
        if det:
            since = 0
        out.append((c, 2 + c * chunk, ba, det))
    return out


def multi_schedule(n_chunks: int, streams: int,
                   n_stream_chunks: int = N_FRAMES // CHUNK,
                   chunk: int = CHUNK, ba_every: int = BA_EVERY) -> list:
    """The timed loop of `run_multi`: per round i, one entry per stream s,
    (chunk tensor (i + 1 + s) % n_stream_chunks, its first frame index, the
    stream's BA pass as (first, window) or None, False: no detection). A
    round runs the S chunks in stream order, then the S BA passes."""
    out = []
    for i in range(n_chunks):
        ba = (max(2 + i * chunk - 3, 0), chunk + 3) \
            if (i * chunk) % ba_every == 0 else None
        row = []
        for s in range(streams):
            c = (i + 1 + s) % n_stream_chunks
            row.append((c, 2 + c * chunk, ba, False))
        out.append(row)
    return out


# The warm-up of every cell, outside the timed window: chunk 0 at frame
# index 2, then a BA pass over keyframes (0, 9), then one detection.
WARMUP_CHUNK, WARMUP_FRAME, WARMUP_BA = 0, 2, (0, 9)


# ---------------------------------------------------------------------------
# FLOPs of one tracked frame

def _conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    return 2 * h * w * cin * cout * k * k


def superpoint_flops(height: int, width: int, channels, desc_dim: int,
                     stem_stride: int = 2) -> int:
    """One image through SuperPointNet (models/superpoint.py), padded to a
    multiple of 8: the 3x3 encoder at the stem's resolution, halved after
    blocks 1, 3 and 5 while pools remain, then both 3x3 heads to 256 and
    the 1x1 projections to 65 cells and to the descriptor."""
    h = (height + (-height) % 8) // stem_stride
    w = (width + (-width) % 8) // stem_stride
    pools = {1: 3, 2: 2, 4: 1}[stem_stride]
    cin = [stem_stride * stem_stride] + list(channels[:-1])
    total = 0
    for i, (a, b) in enumerate(zip(cin, channels)):
        total += _conv(h, w, a, b, 3)
        if i in (1, 3, 5) and pools > 0:
            pools -= 1
            h, w = h // 2, w // 2
    c = channels[-1]
    return total + 2 * _conv(h, w, c, 256, 3) + _conv(h, w, 256, 65, 1) \
        + _conv(h, w, 256, desc_dim, 1)


def lightglue_flops(n: int, m: int, dim: int, heads: int, layers: int,
                    input_dim: int) -> int:
    """One LightGlueNet pass over sets of n and m points (models/
    lightglue.py), with the assignment's similarity f0 f1^T: the input
    projection and the rotary frequencies; per layer the q/k/v/o
    projections of self- and cross-attention (8 d^2 a point), both MLPs
    (12 d^2 a point each), and QK^T and PV of every attention call
    (4 d (n + m)^2 in all); the final projection and the matchability."""
    p = n + m
    per_layer = 40 * p * dim * dim + 4 * dim * p * p
    return (2 * p * input_dim * dim + 2 * p * (dim // heads)
            + layers * per_layer + 2 * p * dim * dim + 2 * p * dim
            + 2 * n * m * dim)


def pair_head_flops(n: int, desc_dim: int, hidden: int, patch: int) -> int:
    """PairSubpixHead (models/subpix.py) on n matched rows."""
    din = 2 * patch * patch + 2 * desc_dim + 1
    return 2 * n * (din * hidden + hidden * hidden + hidden * 2)


def frame_flops(cfg, sp_channels=None, lg_shape=None, head_hidden=128,
                head_patch: int = 7, reobs_lg: bool = True,
                stem_stride: int = 2) -> int:
    """Matmul and convolution FLOPs (2 per multiply-add) of one tracked
    frame of the chunked pipeline at `cfg`'s shapes: the SuperPoint CNN on
    one image, the prologue's LightGlue pass over the frame pair (N x N)
    with its assignment similarity, the pair head on N rows (head_hidden
    None: no pair head), and the re-observation passes at M =
    covis_max_points candidates against the frame's N: two passes in the
    "separate" mode (one without covisibility retrieval), one in "merged",
    the two sets of one batch-2 call in "batched"; each a LightGlue pass
    with its similarity, or with `reobs_lg` False a mutual-NN similarity
    (M x N x D). Not counted: the element-wise work, the geometry's small
    solves, the BA passes and the loop detections (one matcher pass of
    2 x 256 database rows against the frame every 20 frames).
    `sp_channels` / `lg_shape` default to the flagship networks."""
    from gl_slam_tpu_torch.config import FLAGSHIP_LG, FLAGSHIP_SP_CHANNELS
    fe, mp = cfg.frontend, cfg.map
    sp_channels = sp_channels or FLAGSHIP_SP_CHANNELS
    lg = dict(lg_shape or FLAGSHIP_LG)
    n, dd, m = fe.max_keypoints, fe.descriptor_dim, mp.covis_max_points

    def lg_pass(a, b):
        return lightglue_flops(a, b, lg["dim"], lg["heads"], lg["layers"],
                               dd)

    total = superpoint_flops(fe.image_height, fe.image_width, sp_channels,
                             dd, stem_stride) + lg_pass(n, n)
    if head_hidden is not None:
        total += pair_head_flops(n, dd, head_hidden, head_patch)
    if mp.reobs_mode == "merged":
        passes = 1
    elif mp.reobs_mode == "batched":
        passes = 2
    else:
        passes = 2 if mp.use_covis_retrieval else 1
    per_pass = lg_pass(m, n) if reobs_lg else 2 * m * n * dd
    return total + passes * per_pass


# ---------------------------------------------------------------------------
# The cells

class Bench(NamedTuple):
    """The set-up every cell shares (bench.py:52-158)."""
    cfg: Any                 # relaxed: the map, BA and detector config
    sp: Any
    lg: Any
    ks: Any                  # PairSubpixHead
    K: Any                   # (3, 3) float32 on the device
    chunks: list             # (chunk, H, W) float32 tensors on the device
    prev: tuple              # frame 1's oracle kpts, desc, valid
    detect_fn: Any           # ChunkedPipeline._detect_fn
    device: Any
    chunk: int


def setup(cfg, sp, lg, ks, scene, device, n_frames: int = N_FRAMES,
          chunk: int = CHUNK, cache=None) -> Bench:
    """Render n_frames + 2 frames of `scene` (through `cache`), stage them
    on `device` as n_frames / chunk chunk tensors of frames 2 onwards, take
    frame 1's oracle observation for the states' previous-frame features
    and build the loop detector of a `ChunkedPipeline` at `cfg`."""
    import torch

    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline
    from gl_slam_tpu_torch.train import e2e
    fe = cfg.frontend
    frames = e2e.load_or_render(scene, n_frames + 2, fe.max_keypoints, cache)
    chunks = [torch.from_numpy(frames[2 + c * chunk:2 + (c + 1) * chunk])
              .to(device) for c in range(n_frames // chunk)]
    obs = synthetic.observe_frame(scene, 1, max_keypoints=fe.max_keypoints)
    prev = (torch.as_tensor(obs.keypoints, device=device),
            torch.as_tensor(obs.descriptors, device=device),
            torch.as_tensor(obs.valid, device=device))
    pipe = ChunkedPipeline(cfg, scene.K, sp, lg, chunk=chunk,
                           ba_every=BA_EVERY, device=device, subpix_head=ks)
    _sync(device)
    return Bench(cfg, sp, lg, ks, pipe.K, chunks, prev, pipe._detect_fn,
                 device, chunk)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def mkstate(b: Bench):
    """An empty tracking state whose previous-frame features are frame 1's
    oracle observation (bench.py:136-142)."""
    from gl_slam_tpu_torch.slam import frontend
    st = frontend.init_track_state(
        b.cfg, device=b.device, patch=None if b.ks is None else b.ks.patch)
    kp, desc, valid = b.prev
    return st._replace(prev_kpts=kp, prev_desc=desc, prev_valid=valid)


def detection_draws(b: Bench, st):
    """The loop detector's Gumbel draws, one fixed tensor (seed 7)."""
    import torch

    from gl_slam_tpu_torch.slam import loopclose
    cfg = b.cfg
    gen = torch.Generator(device=b.device).manual_seed(DETECT_SEED)
    shape = (cfg.runtime.loop_candidates, cfg.geometry.pnp_hypotheses,
             st.map.kf_db_idx.shape[1])
    return loopclose.pnp_draws(gen, shape, device=b.device)


def _launches() -> dict:
    from gl_slam_tpu_torch.ops import _build
    return dict(_build.LAUNCHES)


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def run_single(b: Bench, reobs_lg: bool, n_chunks: int = 8, cfg_run=None,
               with_loop_detect: bool = True):
    """One stream (bench.py:160-199) -> (tracked fps, kernel launches of
    the timed window). Warm-up: chunk 0 at frame 2, a BA pass over
    keyframes (0, 9) and one detection, then a synchronisation; then the
    timed loop of `single_schedule` (detections issued, their verdicts
    never read) up to one final synchronisation. The BA passes and the
    detector run at `b.cfg` (bench.py's `ba1` and `detect_fn`), the chunk
    at `cfg_run`."""
    import torch

    from gl_slam_tpu_torch.slam import ba as ba_mod
    from gl_slam_tpu_torch.slam import fused
    cfg_run = cfg_run or b.cfg
    fn = fused.build_chunk_fn(cfg_run, b.sp, b.lg, b.K, b.chunk,
                              reobs_with_lightglue=reobs_lg,
                              subpix_head=b.ks)
    gen = torch.Generator(device=b.device).manual_seed(0)  # as mkstate(0)
    hyp = cfg_run.geometry.essential_hypotheses

    def draw():
        return torch.rand((b.chunk, hyp, 8), generator=gen, device=b.device)

    st = mkstate(b)
    gumbel = detection_draws(b, st)
    st, _, _ = fn(st, b.chunks[WARMUP_CHUNK], WARMUP_FRAME, draw())
    st = st._replace(map=ba_mod.ba_step(b.cfg, b.K, st.map, *WARMUP_BA))
    if with_loop_detect:
        b.detect_fn(st, gumbel)
    _sync(b.device)
    before = _launches()
    t0 = time.perf_counter()
    for c, frame, ba, det in single_schedule(n_chunks, len(b.chunks),
                                             b.chunk):
        st, _, _ = fn(st, b.chunks[c], frame, draw())
        if ba is not None:
            st = st._replace(map=ba_mod.ba_step(b.cfg, b.K, st.map, *ba))
        if det and with_loop_detect:
            b.detect_fn(st, gumbel)
    _sync(b.device)
    dt = time.perf_counter() - t0
    return n_chunks * b.chunk / dt, _delta(before)


def run_multi(b: Bench, n_chunks: int = MULTI_CHUNKS, streams: int = S):
    """`streams` sequences time-multiplexed on the one card
    (bench.py:201-240) -> (aggregate tracked fps, kernel launches of the
    timed window): each stream tracks its own single-stream chunks (one
    shared chunk function), its RANSAC draws from a generator seeded with
    its index. Warm-up per stream: chunk 0 at frame 2 and a BA pass over
    (0, 9); then the rounds of `multi_schedule`."""
    import torch

    from gl_slam_tpu_torch.slam import ba as ba_mod
    from gl_slam_tpu_torch.slam import fused
    fn = fused.build_chunk_fn(b.cfg, b.sp, b.lg, b.K, b.chunk,
                              reobs_with_lightglue=True, subpix_head=b.ks)
    hyp = b.cfg.geometry.essential_hypotheses
    gens = [torch.Generator(device=b.device).manual_seed(s)
            for s in range(streams)]

    def draw(s):
        return torch.rand((b.chunk, hyp, 8), generator=gens[s],
                          device=b.device)

    states = []
    for s in range(streams):
        st, _, _ = fn(mkstate(b), b.chunks[WARMUP_CHUNK], WARMUP_FRAME,
                      draw(s))
        states.append(st._replace(map=ba_mod.ba_step(b.cfg, b.K, st.map,
                                                     *WARMUP_BA)))
    _sync(b.device)
    before = _launches()
    t0 = time.perf_counter()
    for row in multi_schedule(n_chunks, streams, len(b.chunks), b.chunk):
        for s, (c, frame, _, _) in enumerate(row):
            states[s], _, _ = fn(states[s], b.chunks[c], frame, draw(s))
        for s, (_, _, ba, _) in enumerate(row):
            if ba is not None:
                states[s] = states[s]._replace(map=ba_mod.ba_step(
                    b.cfg, b.K, states[s].map, *ba))
    _sync(b.device)
    dt = time.perf_counter() - t0
    return n_chunks * b.chunk * streams / dt, _delta(before)


def run_cells(b: Bench, cfgs: dict, single_chunks=None,
              multi_chunks: int = MULTI_CHUNKS, streams: int = S) -> dict:
    """Every cell in bench.py's order (the multi-stream one first) -> {key
    of the line: (fps, launches)}. `single_chunks` replaces every
    single-stream cell's chunk count (None: bench.py's 8 and 4)."""
    cells = {MULTI_KEY: run_multi(b, multi_chunks, streams)}
    for key, name, reobs_lg, n in SINGLE_CELLS:
        cells[key] = run_single(b, reobs_lg, single_chunks or n, cfgs[name])
    return cells


def result_line(fps: dict, cfgs: dict, streams: int = S,
                flops_kw=None) -> dict:
    """The JSON line: bench.py's keys in its order (fps rounded as there),
    the roofline fields from `frame_flops` (its keyword arguments
    `flops_kw`) on the H100's bf16 peak, then the port's FLOP counts.
    `fps`: {key of the line: fps}."""
    kw = flops_kw or {}
    f_strict = frame_flops(cfgs["strict"], **kw)
    f_relaxed = frame_flops(cfgs["relaxed"], **kw)
    line = {
        "metric": METRIC,
        "value": round(fps["value"], 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps["value"] / NORTH_STAR_FPS, 4),
        "weights": "trained-flagship",
    }
    for key, _, _, _ in SINGLE_CELLS[:1] + SINGLE_CELLS[2:]:
        line[key] = round(fps[key], 2)
    line[MULTI_KEY] = round(fps[MULTI_KEY], 2)
    line.update({
        "streams": streams,
        "ba_every_frames": BA_EVERY,
        "strict_roofline_fps_at_100pct_mfu":
            round(H100_BF16_PEAK_FLOPS / f_strict, 1),
        "relaxed_roofline_fps_at_100pct_mfu":
            round(H100_BF16_PEAK_FLOPS / f_relaxed, 1),
        "flops_per_frame_strict": f_strict,
        "flops_per_frame_relaxed": f_relaxed,
    })
    return line


def check_line(line: dict) -> None:
    """Raise unless the line carries every key of bench.py's line and the
    port's FLOP keys, with finite positive fps."""
    missing = [k for k in BENCH_KEYS + FLOP_KEYS if k not in line]
    if missing:
        raise ValueError(f"bench line lacks {missing}")
    for key, _, _, _ in SINGLE_CELLS:
        if not (math.isfinite(line[key]) and line[key] > 0):
            raise ValueError(f"{key} = {line[key]}")
    if not (math.isfinite(line[MULTI_KEY]) and line[MULTI_KEY] > 0):
        raise ValueError(f"{MULTI_KEY} = {line[MULTI_KEY]}")


# ---------------------------------------------------------------------------

def flagship_checkpoints(ckpt_dir: str) -> None:
    """Raise unless the trained flagship weights are there: a random init
    would hide a broken load."""
    for name in ("sp_flagship", "lg_flagship", "kspair_flagship"):
        path = os.path.join(ckpt_dir, f"{name}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} is missing: the bench runs the "
                                    "trained flagship weights only")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without CUDA)")
    ap.add_argument("--checkpoints", default=os.path.join(ROOT,
                                                          "checkpoints"))
    ap.add_argument("--ms-econ", action="store_true",
                    help="run scripts/profile_multistream_torch.py "
                         "(MS_ECON_TORCH.json) instead")
    ap.add_argument("--out", default=None,
                    help="also write the line, the card and each cell's "
                         "unrounded fps and launches here")
    args = ap.parse_args(argv)

    from gl_slam_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    if args.ms_econ:
        return subprocess.call([sys.executable, os.path.join(
            ROOT, "scripts", "profile_multistream_torch.py"),
            "--out", "MS_ECON_TORCH.json"])
    flagship_checkpoints(args.checkpoints)

    from gl_slam_tpu_torch.config import flagship_config
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.train import e2e
    if dev.type == "cuda":
        import chip_smoke
        card = chip_smoke.card_line()
        _build.build_all()
    else:
        card = "cpu"
    print(f"card: {card}", flush=True)
    t_start = time.perf_counter()
    cfgs = variants(flagship_config(H, W))
    sp, lg = e2e.load_flagship_frontend(args.checkpoints, device=dev)
    ks = e2e.load_flagship_subpix(args.checkpoints, pair=True, device=dev)
    scene = synthetic.make_scene(num_landmarks=LANDMARKS,
                                 num_frames=N_FRAMES + 2, height=H, width=W,
                                 desc_dim=D, seed=0)
    cache = os.path.join(tempfile.gettempdir(),
                         f"bench_torch_frames_s0_{N_FRAMES + 2}_{H}x{W}.npy")
    b = setup(cfgs["relaxed"], sp, lg, ks, scene, dev, cache=cache)
    print(f"setup {time.perf_counter() - t_start:.1f} s", flush=True)
    cells = run_cells(b, cfgs)
    for key, (fps, launches) in cells.items():
        print(f"{key}: {fps:.4f} fps, launches {launches} [{card}]",
              flush=True)
    line = result_line({k: v[0] for k, v in cells.items()}, cfgs)
    check_line(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(line=line, card=card, cells={
                k: dict(fps=fps, launches=launches)
                for k, (fps, launches) in cells.items()},
                wall_s=time.perf_counter() - t_start), f, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
