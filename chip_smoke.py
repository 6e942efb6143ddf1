#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gl_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # all phases, one card

Phases (any failure exits non-zero and prints no result line):
  1. build the hand-written CUDA kernels from gl_slam_tpu_torch/csrc/
     (one nvcc per source, in parallel) and print the card's name and power
     limit;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the tracker gives it (ragged masks, a fully masked row/column,
     constructed ties, plateaus across strip, segment and image borders, a real
     detector heatmap) within an elementwise error bound (attention,
     assignment) or bit for bit (NMS), and time kernel, plain version, a
     PyTorch library yardstick and the roofline bound;
  3. run the flagship-width chunked tracker (376x1241, N=2048, D=256, a
     9-layer 2-head LightGlue on all three per-frame passes, committed
     weights, extraction through the NMS kernel) over a bootstrap plus
     three chunks of 8 frames of a rendered scene, with a window BA pass,
     slot recycling and the health check every 8 frames, loop closing off
     and centroid sub-pixel refinement; check poses, matches, ATE, the BA
     and recovery counts and that the launch counters equal what the path
     implies;
  4. run the same tracker with BA off over the bootstrap plus one chunk of
     the same frames, with its own launch-count check;
  5. run the BA-on tracker in pair mode (the learned pair sub-pixel head,
     committed kspair_flagship.npz, refining the matched keypoints in every
     chunk prologue) over the bootstrap plus two chunks of the same frames,
     held to phase 3's guards, beside phase 3's run over the same frames,
     with the host time of the refinement from a profiled run;
  6. run the round's "Done" scenario through the code of
     scripts/eval_flagship_torch.py (gl_slam_tpu_torch.train.evals): 120
     frames of the held-out flagship sequence (seed 101, forward_turn),
     pair head, window BA every 8 frames and loop closing on (keyframe-
     database detection every 20 frames past 50), unprofiled, held to the
     bounds of tests/test_flagship_e2e.py, 0 recoveries, the detections
     the cadence implies and the launch counts the path implies;
  7. run the port's command line (gl_slam_tpu_torch.cli, the chunked
     learned route) on a KITTI-layout directory it writes first (31 8-bit
     PNG frames of a 31-frame scene like phase 3's, calib.txt, GT poses):
     flagship preset, the single-view sub-pixel head, chunks of 8 with BA
     every 8, so a bootstrap, three chunks and a tail of 5 real frames
     padded to 8 and gated off; check the report (31 frames fed and
     tracked, 3 rejected, ATE, matches over the real frames, BA count, 0
     recoveries), the artifacts and the launch counts after the warm-up.
     The KITTI route reads through the native PNG prefetch loader (its own
     PNG reader, built with g++ at first use; the phase fails if it does
     not build), and the loader's frame counter must equal the frames fed;
     the phase prints the host ms per frame spent waiting for frames, then
     the same wait on PIL and on the loader in turns over the first 18
     frames;
  8. run the command line's per-frame route on the same directory:
     `--frontend superpoint --per-frame --preset flagship` (batch-1
     extraction through the NMS kernel at the CLI's radius 3, LightGlue
     and the fused assignment on every pass, the essential RANSAC inside
     each step, async BA), held to: every frame the ground-truth gate lets
     through tracked, ATE <= 1 m, no recovery, the launch counts the path
     implies; a profiled run of its first 12 frames for the idle share and
     host time by stage; then `--frontend harris` at full width (NMS kernel
     at radius 4) and the default oracle route (synthetic sequence), each
     with `--live-viz 8 --checkpoint`, and their artifacts; the learned
     run's frame fetches, loader counter and host wait per frame as in
     phase 7 (the loader must build here too).
  9. run the chunked tracker of phase 3 (same frames, BA every 8, centroid
     refinement, loop closing off, same draws) once per tracker option:
     the batched and the merged re-observation modes (one matcher pass a
     frame for the re-observations instead of two), the PnP tracker,
     motion-gated keyframing at the default filters (every frame passes
     them here; the keyframe poses must equal phase 3's within the spread
     of phase 3's own repeated runs) and at 1e6 (only the bootstrap pair
     kept; every tracked frame but a chunk's first takes the recovery
     branch); each held to the launch counts its mode implies, 0
     health-check recoveries, a finite state and, but for the last, phase
     3's guards; the batched run profiled once;
 10. multi-stream tracking on the stream axis (gl_slam_tpu_torch.parallel,
     slam/fused.build_multistream_chunk_fn) at flagship width: four
     streams, phase 3's frames at offsets 0, 2, 4 and 6, each with its own
     RANSAC draws, bootstrapped through MultiStreamTracker.bootstrap on
     extracted features, then two multi-stream chunks of 8 with a
     stream-batched window BA after each; every stream keeps all its frames
     with no recovery-branch frame, its ATE (in its first frame's camera
     coordinates) within phase 3's bound, and its keyframe poses within
     the bound stated there of its own single-stream run on the same
     draws; attention and assignment launch as often per chunk as for one
     stream; then the four streams for one chunk, each through its own
     camera (K (S, 3, 3): f and the principal point moved by 1-3 %, the
     frames rendered through it), each held to its own single-stream run
     with its own K within the same bound, attention and assignment again
     as for one stream; then one chunk at 16 streams (BASELINE
     configs[4]), with the peak memory and the launch counts.
Phase 2 also holds attention and the assignment at the loop detector's
shapes (2 candidates' 256-row keyframe databases against the 2048-keypoint
frame, random database masks, one empty database) and at the per-frame
route's (one pair of 2048-keypoint sets; NMS of one map at radius 3 and of
a Harris response at radius 4), and at the batched re-observation
mode's (the window and covisibility sets, 1024 points each, on a leading
set axis of 2 against the 2048-keypoint frame), and at the multi-stream
chunk's with 4 and 16 streams (the prologue's S x 8 pairs, S
re-observation sets; NMS of 16 maps, extraction in groups of 2 streams).
 11. front-end training (gl_slam_tpu_torch/train/frontend_train.py) at
     the flagship preset's width (376x1240, N=2048, D=256, the 9-layer
     2-head matcher) on one rendered 20000-landmark scene of 8 frames:
     3 steps of each of train_superpoint, train_subpix, train_pair_subpix
     and train_lightglue (batch 2, descriptor age 6, jitter 1 px), each
     held to the launch counts it implies (the matcher's attention kernel
     once per call forward, never backward; NMS once per 8 staged
     frames); the matcher's gradient through the kernel against the plain
     version, parameter by parameter, within a tolerance drawn from
     attention_tolerance, every q/k/v weight's gradient non-zero; 30
     steps on fixed batches lowering the SuperPoint loss below 0.7 x its
     first and the matcher's below its first; and save_params read back
     by the port's loader into bit-equal forwards.
Phase 2 also holds attention and NMS at the training shapes (2 pairs x 2
sets x 2 heads, 2048 x 2048; 8 maps of 376 x 1240 at radius 3).
 12. the batched entry points on the card with the committed flagship
     weights: SuperPointExtractor on two rendered frames and
     LightGlueMatcher on their pair, held to their launch counts and equal
     bit for bit to the chunk's extraction (a one-pixel refinement window)
     and the prologue's matcher; then the native covisibility graph
     (runtime/native_lib.CovisGraph, built with g++) over phase 3's final
     keyframe / point table: its edge count against the plain rule, one
     query and one points_of.
 13. point-table turnover at flagship width: the long run's scene
     (scripts/longrun_learned_torch.py --preset flagship: seed 11,
     forward_turn_band, 170 landmarks a metre over 1000 frames) for its
     first 66 frames through `run_learned_e2e`, pair head, BA every 8,
     loop closing on, 1024 keyframe slots, the point table pinned to
     TURNOVER_MAX_POINTS and both recycling ages to TURNOVER_AGE
     keyframes, so that the run creates more than twice the table in new
     points and the eviction under pressure (state.recycle_free_slots'
     `stale_age` branch) frees healthy points; held to
     tests/test_longrun.py's bounds, every frame kept, 0 recoveries, the
     launch counts the path implies; prints the free slots after each BA
     pass and how many of them the eviction under pressure freed.
The line before the last is the `kernels` JSON (the three kernels at the
shapes of phase 13's run, with its launches); the last line is the device
JSON. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Roofline of one H100 SXM at its published peaks (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_BYTES = 3.35e12
SPIN_CYCLES = 50_000_000        # spin kernel ahead of a timed run, ~25 ms

CHUNK = 8
N_CHUNKS = 3
N_FRAMES = 2 + N_CHUNKS * CHUNK
N_FRAMES_NO_BA = 2 + CHUNK      # the earlier path (BA off), at a cut depth
N_CHUNKS_PAIR = 2
N_FRAMES_PAIR = 2 + N_CHUNKS_PAIR * CHUNK   # the pair sub-pixel head's path
NMS_RADIUS = 4
# Kernel shapes on the flagship path: N keypoints per frame, M synthetic
# re-observation points, 2 heads of 128 dims, 256-d final projections.
N_KPTS, M_REOBS, HEADS, HEAD_DIM, FEAT_DIM = 2048, 1024, 2, 128, 256
# csrc/assignment.cu launches two kernels per call (the lse pass and the
# argmax pass); attention.cu and nms.cu launch one.
ASSIGN_KERNELS_PER_CALL = 2
# The loop detector: `loop_candidates` keyframe databases of
# `loop_db_keypoints` rows matched against the frame's N keypoints in one
# matcher call; the sets differ in size, so each of the 9 layers makes 4
# attention calls (self at each size, cross both ways).
LOOP_CANDS, LOOP_DB = 2, 256
ATTN_PER_DETECTION = 9 * 4
DONE_FRAMES = 120                 # the flagship eval's sequence (phase 6)
# The command line (phase 7): a bootstrap, three chunks and a tail of 5
# real frames padded to a chunk.
CLI_FRAMES = 2 + 3 * CHUNK + 5
CLI_CHUNKS = 4
# Multi-stream tracking (phase 10): four streams at these offsets into
# phase 3's frames, two chunks each; then one chunk at 16 streams
# (BASELINE configs[4]), extraction in groups of 2 streams. Phase 2 holds
# the kernels at both stream counts.
MS_OFFSETS = (0, 2, 4, 6)
MS_CHUNKS = 2
MS_BIG = 16
MS_BIG_GROUP = 2
MS_STREAMS = (len(MS_OFFSETS), MS_BIG)
# Then the four streams again for one chunk, each with its own camera: f
# and the principal point moved by these fractions (KITTI's sequences 00-02,
# 03 and 04-12 come with three calibrations).
MS_F_MOVE = (0.01, -0.02, 0.03, -0.015)
MS_C_MOVE = (-0.01, 0.02, -0.03, 0.015)
# Front-end training at flagship width (phase 11): the flagship preset of
# scripts/train_frontend_torch.py (376 x 1240, N 2048, D 256), one scene of
# 20000 landmarks, TRAIN_FRAMES rendered frames, TRAIN_STEPS steps of each
# trainer; the matcher takes batches of TRAIN_PAIRS pairs, each layer one
# self- and one cross-attention call over the 2 stacked sets; feature
# staging detects with NMS radius TRAIN_NMS_RADIUS in calls of 8 frames.
TRAIN_H, TRAIN_W, TRAIN_FRAMES, TRAIN_STEPS, TRAIN_PAIRS = 376, 1240, 8, 3, 2
TRAIN_NMS_RADIUS, LG_LAYERS = 3, 9
DESCENT_STEPS = 30
# Point-table turnover (phase 13): the long run's scene (1000 frames of
# scripts/longrun_learned_torch.py --preset flagship) for its first
# TURNOVER_FRAMES frames, 1024 keyframe slots as in the long run, the point
# table pinned to TURNOVER_MAX_POINTS (the run triangulates ~220 points a
# frame, so ~14 k in 64 tracked frames: more than twice the table) and both
# recycling ages (`recycle_min_age`, `recycle_stale_age`; 32 and 64 by
# default) cut to TURNOVER_AGE keyframes, one past the map-match window of
# 20, so that healthy points age out for eviction inside the phase.
LONGRUN_SCENE_FRAMES = 1000
TURNOVER_FRAMES = 66
TURNOVER_MAX_POINTS = 6144
TURNOVER_MAX_KEYFRAMES = 1024
TURNOVER_AGE = 21


def expected_launches(n_chunks, reobs_mode="separate"):
    """Kernel launches of a bootstrap plus `n_chunks` chunks. Matcher passes:
    the bootstrap's and each chunk prologue's (18 attention calls: 9 layers
    x self + cross), and the re-observation passes of each frame: two in
    the "separate" mode (72: 9 layers x 2 passes x (2 self + 2 cross, per
    set at its own size)), one in the "merged" and "batched" modes (36: the
    batched mode's two sets ride a leading axis of the same calls); one
    assignment call per matcher pass; one fused NMS launch per extraction
    call (bootstrap and each chunk). The PnP tracker and motion gating
    launch what the separate mode does (the chunk's recovery branch
    matches by mutual nearest neighbours)."""
    tracked = n_chunks * CHUNK
    passes = 2 if reobs_mode == "separate" else 1
    return {"attention": 18 + n_chunks * 18 + tracked * 36 * passes,
            "assignment": ASSIGN_KERNELS_PER_CALL * (1 + n_chunks
                                                     + tracked * passes),
            "nms": 1 + n_chunks}


# The per-frame route (phase 8): the command line's NMS radius (3) on the
# learned detector, Harris's (4); the profiled run's depth.
PF_NMS_RADIUS, HARRIS_RADIUS = 3, 4
PF_PROFILE_FRAMES = 12
ORACLE_FRAMES = 41                # the default route: --last-frame 40


def expected_launches_per_frame(steps, n_kpts=N_KPTS, reobs_points=N_KPTS):
    """Kernel launches of the per-frame learned route over a bootstrap and
    `steps` tracked frames: two batch-1 extractions and one matcher pass at
    the bootstrap; per step one extraction and three matcher passes (pass 1
    and the two re-observation passes). A pass over two sets of equal size
    makes 18 attention calls (9 layers x self + cross, the sets stacked),
    of unequal size 36; the command line sets the re-observation sets to
    min(kpts, 2048) points, the frame's size. One assignment call per
    pass."""
    reobs = 18 if reobs_points == n_kpts else 36
    return {"attention": 18 + steps * (18 + 2 * reobs),
            "assignment": ASSIGN_KERNELS_PER_CALL * (1 + 3 * steps),
            "nms": 2 + steps}


class Failure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, warmup=3):
    """Device time per call of `reps` calls back to back, by CUDA events.
    A spin kernel ahead of the first event holds the stream while the host
    issues all the calls, so that the events time the device and not the
    host's issue rate (which bounds the short re-observation calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions

def needle_qkv(torch, rnd, lead, nq, nk):
    """Random k and v; query i is 0.75 x key (997 i) mod nk, so about half of
    its softmax mass sits on that one key and its output is large against
    the tolerance. The keys so picked lie in every key tile, so a dropped
    tile, a wrong mask or mis-scaled logits move outputs far past it."""
    k = rnd(*lead, HEADS, nk, HEAD_DIM)
    v = rnd(*lead, HEADS, nk, HEAD_DIM)
    j = (torch.arange(nq, device=k.device) * 997) % nk
    q = (0.75 * k.float()[..., j, :]).to(k.dtype)
    return q, k, v


def attention_cases(torch, gen, dev):
    """(name, q, k, v, mask) at the tracker's shapes: the prologue call
    (8 pairs x 2 sets x 2 heads, 2048 x 2048), the four re-observation
    calls (1 set x 2 heads, (Nq, Nk) in {1024, 2048}^2) and the batched
    mode's four (2 sets x 2 heads, the same (Nq, Nk))."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    cases = []
    T, S, N, M = CHUNK, 2, N_KPTS, M_REOBS
    q, k, v = needle_qkv(torch, rnd, (T, S), N, N)
    counts = torch.randint(N // 2, N + 1, (T, S), generator=gen, device=dev)
    counts[2, 1] = 5                                           # near empty
    mask = torch.arange(N, device=dev) < counts[..., None]     # ragged
    mask[0, 1] = False                                         # all masked
    mask[1, 0] = torch.rand(N, generator=gen, device=dev) < 0.5
    cases.append((f"prologue {T}x{S}x{HEADS}x{N}x{N}", q, k, v, mask))
    for nq, nk in ((M, M), (N, N), (M, N), (N, M)):
        q, k, v = needle_qkv(torch, rnd, (), nq, nk)
        mask = torch.rand(nk, generator=gen, device=dev) < 0.8
        cases.append((f"reobs {HEADS}x{nq}x{nk}", q, k, v, mask))
    # Every key masked: the output is the uniform mean of v (mean ~1 here,
    # so that the check is far above its tolerance).
    q, k, v = needle_qkv(torch, rnd, (), M, N)
    v = (v.float() + 1.0).to(torch.bfloat16)
    cases.append((f"reobs {HEADS}x{M}x{N} all keys masked", q, k, v,
                  torch.zeros(N, dtype=torch.bool, device=dev)))
    # The loop detector: 2 candidates x 2 heads, database (256) and frame
    # (2048) sides. Database keys carry random masks and the second
    # candidate's database is empty (its v offset by 1 as above).
    Q, B = LOOP_CANDS, LOOP_DB
    for nq, nk in ((B, B), (N, N), (B, N), (N, B)):
        q, k, v = needle_qkv(torch, rnd, (Q,), nq, nk)
        if nk == B:
            mask = torch.rand(Q, nk, generator=gen, device=dev) < 0.7
            mask[1] = False
            v[1] = (v[1].float() + 1.0).to(torch.bfloat16)
        else:
            mask = torch.rand(Q, nk, generator=gen, device=dev) < 0.9
        cases.append((f"detect {Q}x{HEADS}x{nq}x{nk}", q, k, v,
                      mask.contiguous()))
    # The batched re-observation mode: the window and covisibility sets
    # (1024 points each) against the frame (2048) on a leading set axis of
    # 2, each set with its own random mask.
    for nq, nk in ((M, M), (M, N), (N, M), (N, N)):
        q, k, v = needle_qkv(torch, rnd, (S,), nq, nk)
        mask = torch.rand(S, nk, generator=gen, device=dev) < 0.8
        cases.append((f"batched {S}x{HEADS}x{nq}x{nk}", q, k, v, mask))
    # The per-frame route: every matcher pass is one pair of 2048-keypoint
    # sets, stacked (2 sets x 2 heads), ragged masks.
    q, k, v = needle_qkv(torch, rnd, (S,), N, N)
    counts = torch.randint(N // 2, N + 1, (S,), generator=gen, device=dev)
    mask = torch.arange(N, device=dev) < counts[:, None]
    cases.append((f"per-frame {S}x{HEADS}x{N}x{N}", q, k, v, mask))
    # Front-end training (phase 11): 2 pairs x 2 stacked sets x 2 heads,
    # ragged masks (the GT keypoints of a rendered frame fill a prefix).
    q, k, v = needle_qkv(torch, rnd, (TRAIN_PAIRS, S), N, N)
    counts = torch.randint(N // 2, N + 1, (TRAIN_PAIRS, S), generator=gen,
                           device=dev)
    mask = torch.arange(N, device=dev) < counts[..., None]
    cases.append((f"training {TRAIN_PAIRS}x{S}x{HEADS}x{N}x{N}", q, k, v,
                  mask))
    # The multi-stream chunk (phase 10): the prologue's streams x 8 pairs x
    # 2 sets, ragged, and the re-observation calls with the streams in
    # front, each stream its own mask.
    for ns in MS_STREAMS:
        q, k, v = needle_qkv(torch, rnd, (ns, T, S), N, N)
        counts = torch.randint(N // 2, N + 1, (ns, T, S), generator=gen,
                               device=dev)
        counts[0, 2, 1] = 5
        mask = torch.arange(N, device=dev) < counts[..., None]
        mask[-1, 0, 1] = False
        cases.append((f"streams prologue {ns}x{T}x{S}x{HEADS}x{N}x{N}", q, k,
                      v, mask))
        for nq, nk in ((M, M), (N, N), (M, N), (N, M)):
            q, k, v = needle_qkv(torch, rnd, (ns,), nq, nk)
            mask = torch.rand(ns, nk, generator=gen, device=dev) < 0.8
            cases.append((f"streams reobs {ns}x{HEADS}x{nq}x{nk}", q, k, v,
                          mask))
    return cases


def check_attention(torch, gen, dev, report):
    from gl_slam_tpu_torch.ops import attention as A
    F = torch.nn.functional
    worst = 0.0
    for name, q, k, v, mask in attention_cases(torch, gen, dev):
        scale = 1.0 / math.sqrt(q.shape[-1])
        out = A.attention_cuda(q, k, v, mask, scale)
        ref = A.attention_plain(q, k, v, mask, scale)
        # Elementwise bound from the two versions' roundings (derived in
        # attention_tolerance's docstring), not a multiple of max|v|.
        tol = A.attention_tolerance(q, k, v, mask, scale)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"attention {name}: non-finite")
        diff = (out - ref).abs()
        err = float(diff.max())
        over = float((diff / tol).max())
        check(over <= 1.0, f"attention {name}: |err| reaches {over:.3g} x "
              f"its bound (max|err| {err})")
        # The check must be able to fail: typical outputs stand far above
        # the bound.
        strength = float(ref.abs().median() / tol.median())
        check(strength >= 10.0, f"attention {name}: median |ref| only "
              f"{strength:.3g} x the median bound")
        # Sets with every key masked average v; the kernel's weights are then
        # exactly 1, so only the f32 sum over Nk keys is inexact.
        Nk = k.shape[-2]
        empty = ~mask.reshape(-1, Nk).any(-1)
        uni_err = 0.0
        if bool(empty.any()):
            vs = v.float().reshape(-1, *v.shape[-3:])[empty]
            os_ = out.reshape(-1, *out.shape[-3:])[empty]
            uni = vs.mean(-2, keepdim=True)
            utol = Nk * 2.0 ** -22 * vs.abs().mean(-2, keepdim=True) + 1e-6
            uni_err = float(((os_ - uni).abs() / utol).max())
            check(uni_err <= 1.0, f"attention {name}: a fully masked set is "
                  f"not the mean of v ({uni_err:.3g} x its bound)")
        worst = max(worst, err)
        lead = math.prod(q.shape[:-2])
        Nq, dh = q.shape[-2:]
        flops = 4.0 * lead * Nq * Nk * dh
        nbytes = 2 * (q.numel() + k.numel() + v.numel()) + mask.numel() \
            + 4 * out.numel()
        H = q.shape[-3]
        q_tile, key_tile, splits = A.split_plan(lead, Nq, Nk)
        ctas = -(-Nq // q_tile) * lead * splits
        q4, k4, v4 = (x.reshape(-1, H, *x.shape[-2:]) for x in (q, k, v))
        bias = torch.where(mask.reshape(-1, Nk), 0.0, -1e9).to(
            torch.bfloat16)[:, None, None, :]
        row = dict(
            shape=name, key_tile=key_tile, splits=splits, ctas=ctas,
            max_abs_err=err, max_err_over_bound=over,
            median_ref_over_bound=strength, masked_set_err_over_bound=uni_err,
            ms=time_ms(lambda: A.attention_cuda(q, k, v, mask, scale)),
            plain_ms=time_ms(lambda: A.attention_plain(q, k, v, mask, scale),
                             reps=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=bias, scale=scale)))
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
        report.append(row)
        del tol, diff
        print(f"  attention {name}: key split S={splits}, {ctas} CTAs, "
              f"{key_tile}-key tiles; max|err| {err:.3g}, <= {over:.3g} x "
              f"the bound, median|ref| {strength:.3g} x the bound; kernel "
              f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms sdpa "
              f"{row['library_ms']:.4f} ms bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
    return worst


def assignment_cases(torch, gen, dev):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    cases = []
    for name, B, N, M in (
            (f"prologue {CHUNK}x{N_KPTS}x{N_KPTS}", CHUNK, N_KPTS, N_KPTS),
            (f"bootstrap and per-frame 1x{N_KPTS}x{N_KPTS}", 1, N_KPTS,
             N_KPTS),
            (f"reobs 1x{M_REOBS}x{N_KPTS}", 1, M_REOBS, N_KPTS),
            (f"batched 2x{M_REOBS}x{N_KPTS}", 2, M_REOBS, N_KPTS),
            (f"batched 2x{N_KPTS}x{N_KPTS}", 2, N_KPTS, N_KPTS),
            (f"detect {LOOP_CANDS}x{LOOP_DB}x{N_KPTS}", LOOP_CANDS, LOOP_DB,
             N_KPTS),
            *((f"streams prologue {ns * CHUNK}x{N_KPTS}x{N_KPTS}",
               ns * CHUNK, N_KPTS, N_KPTS) for ns in MS_STREAMS),
            *((f"streams reobs {ns}x{M_REOBS}x{N_KPTS}", ns, M_REOBS,
               N_KPTS) for ns in MS_STREAMS)):
        f0 = (rnd(B, N, FEAT_DIM) / 4).to(torch.bfloat16)
        f1 = (rnd(B, M, FEAT_DIM) / 4).to(torch.bfloat16)
        z0, z1 = rnd(B, N), rnd(B, M)
        m0 = torch.rand(B, N, generator=gen, device=dev) < 0.9
        m1 = torch.rand(B, M, generator=gen, device=dev) < 0.9
        m1[0, 7] = False                          # fully masked column
        m0[0, 3] = False                          # fully masked row
        # Row 40 strongly prefers column 100 and column 60 row 150; the
        # duplicates (column 200, row 300 or 200, with equal matchability)
        # give equal objectives, which must resolve to the smaller index.
        dup = 300 if N > 300 else 200
        f1[0, 100] = f0[0, 40] * 4
        f0[0, 150] = f1[0, 60] * 4
        z1[0, 100] = z0[0, 150] = 5.0
        f1[0, 200], z1[0, 200] = f1[0, 100], z1[0, 100]
        f0[0, dup], z0[0, dup] = f0[0, 150], z0[0, 150]
        m0[0, [40, 150, dup]] = True
        m1[0, [60, 100, 200]] = True
        if name.startswith("detect"):
            m0[-1, :] = False                     # an empty database
        elif B > 1:
            m1[-1, :] = False                     # fully masked columns
            m1[-1, 9] = True
        cases.append((name, f0, f1, z0, z1, m0, m1))
    return cases


def check_assignment(torch, gen, dev, report):
    from gl_slam_tpu_torch.ops import assignment as AS
    F = torch.nn.functional
    worst = 0.0
    for name, f0, f1, z0, z1, m0, m1 in assignment_cases(torch, gen, dev):
        scale = 1.0 / math.sqrt(FEAT_DIM)
        c0, c1 = F.logsigmoid(z0), F.logsigmoid(z1)
        args = (f0, f1, c0, c1, m0, m1, scale)
        out = AS.fused_reductions_cuda(*args)
        again = AS.fused_reductions_cuda(*args)
        ref = AS.fused_reductions_plain(*args)
        torch.cuda.synchronize()
        # The partials meet in a fixed order whichever CTA ends last.
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"assignment {name}: two calls differ")
        del again
        nn0, v0, lse_r, nn1, v1, lse_c = out
        rnn0, rv0, rlse_r, rnn1, rv1, rlse_c = ref
        # f32 sums of the same 256 bf16 products in another order: values
        # agree to ~1e-5 relative; 1e-3 absolute on values of O(10).
        err = max(float((a - b).abs().max()) for a, b in
                  ((v0, rv0), (lse_r, rlse_r), (v1, rv1), (lse_c, rlse_c)))
        check(err <= 1e-3, f"assignment {name}: max|err| {err}")
        # Indices must agree, except where the plain objective at the
        # kernel's index is within the value tolerance of the plain max
        # (a near-tie that the summation order may break either way).
        sim2 = 2 * scale * torch.matmul(f0.float(), f1.float().transpose(1, 2))
        sim2 = torch.where(m0[..., :, None] & m1[..., None, :], sim2, -1e9)
        obj0 = sim2 + torch.where(m1, c1 - rlse_c, -1e9)[..., None, :]
        obj1 = sim2 + torch.where(m0, c0 - rlse_r, -1e9)[..., :, None]
        got0 = torch.gather(obj0, 2, nn0.long()[..., None])[..., 0]
        got1 = torch.gather(obj1, 1, nn1.long()[:, None, :])[:, 0]
        n_diff = int((nn0 != rnn0).sum()) + int((nn1 != rnn1).sum())
        gap = max(float((rv0 - got0).abs().max()),
                  float((torch.clamp_min(rv1, -1e9) - torch.clamp_min(
                      got1, -1e9)).abs().max()))
        check(gap <= 1e-3, f"assignment {name}: {n_diff} index differences, "
              f"objective gap {gap}")
        del sim2, obj0, obj1
        check(int(nn1[0, 60]) == 150, f"assignment {name}: column tie "
              f"resolved to {int(nn1[0, 60])}, not the smaller row 150")
        check(int(nn0[0, 40]) == 100, f"assignment {name}: row tie "
              f"resolved to {int(nn0[0, 40])}, not the smaller column 100")
        worst = max(worst, err)
        B, N, Df = f0.shape
        M = f1.shape[1]
        row_tile, col_tile, splits = AS.assign_plan(B, N, M)
        ctas = -(-N // row_tile) * B * splits
        flops = 2 * 2.0 * B * N * M * Df            # two passes of f0 f1^T
        nbytes = 2 * (f0.numel() + f1.numel()) + 5 * (B * N + B * M) \
            + 12 * (B * N + B * M)
        row = dict(
            shape=name, row_tile=row_tile, col_tile=col_tile, splits=splits,
            ctas=ctas, max_abs_err=err, tol=1e-3, index_diffs=n_diff,
            ms=time_ms(lambda: AS.fused_reductions_cuda(*args)),
            plain_ms=time_ms(lambda: AS.fused_reductions_plain(*args),
                             reps=5),
            library_ms=time_ms(lambda: torch.matmul(f0, f1.transpose(1, 2))))
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
        report.append(row)
        print(f"  assignment {name}: column split S={splits}, {ctas} CTAs, "
              f"{row_tile}-row x {col_tile}-column tiles; err {err:.3g}, "
              f"{n_diff} index differences (gap {gap:.3g}), equal bits in two "
              f"calls; kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} "
              f"ms bmm {row['library_ms']:.4f} ms bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']})", flush=True)
    return worst


def nms_cases(torch, gen, dev, cfg, sp, stack):
    """(name, heat (B, H, W) f32, radius) at the batch sizes the tracker
    extracts at (8 per chunk and 2 at the bootstrap, 376 x 1248, r 4; 16
    for a chunk of a group of 2 streams on the multi-stream path; 1 on
    the per-frame route at the command line's r 3; Harris's response of
    one 376 x 1241 frame at r 4): a quantised random map (ties everywhere)
    with exact zeros, plateaus that touch the image border and plateaus
    across every column-strip and row-segment corner of the kernel's plan,
    with equal isolated maxima r apart across those borders; and the
    flagship detector's own heatmap of rendered frames, or the Harris
    response of a rendered frame with its border zeroed as
    HarrisExtractor does."""
    from gl_slam_tpu_torch.models import classical
    from gl_slam_tpu_torch.ops import nms as NM
    from gl_slam_tpu_torch.slam import fused
    H = cfg.frontend.image_height
    W = cfg.frontend.image_width
    H8, W8 = H + (-H) % 8, W + (-W) % 8
    cases = []
    for B, r, Hc, Wc in ((CHUNK, NMS_RADIUS, H8, W8), (2, NMS_RADIUS, H8, W8),
                         (1, PF_NMS_RADIUS, H8, W8), (1, HARRIS_RADIUS, H, W),
                         (MS_BIG_GROUP * CHUNK, NMS_RADIUS, H8, W8)):
        heat = torch.rand(B, Hc, Wc, generator=gen, device=dev)
        heat = torch.round(heat * 64) / 64
        heat[torch.rand(B, Hc, Wc, generator=gen, device=dev) < 0.3] = 0.0
        plan = NM.nms_plan(B, Hc, Wc, r)
        for x in range(plan["strip_cols"], Wc, plan["strip_cols"]):
            heat[:, 2, x - 1] = heat[:, 2, min(x - 1 + r, Wc - 1)] = 1.995
            for y in range(plan["seg_rows"], Hc, plan["seg_rows"]):
                heat[:, y - 2:y + 2, x - 3:x + 3] = 1.97   # across a corner
        for y in range(plan["seg_rows"], Hc, plan["seg_rows"]):
            heat[:, y - 1, 5] = heat[:, min(y - 1 + r, Hc - 1), 7] = 1.993
        heat[0, 120:136, 600:700] = 1.98       # across several strips
        heat[0, :5, :7] = 1.99                 # image corner
        heat[-1, Hc - 3:, Wc - 40:] = 1.98     # bottom-right border
        heat[-1, Hc // 2, :] = 1.96            # a full row
        heat[-1, :, 64] = 1.95                 # a full column
        tag = f"{B}x{Hc}x{Wc} r{r}"
        cases.append((f"random {tag}", heat.contiguous(), r))
        img = torch.from_numpy(stack[:B]).to(dev)
        with torch.no_grad():
            if Wc == W:                        # Harris on the frame itself
                real = classical.harris_response(img)
                b = 8                          # HarrisExtractor's patch
                real[:, :b], real[:, H - b:] = 0.0, 0.0
                real[:, :, :b], real[:, :, W - b:] = 0.0, 0.0
                cases.append((f"harris {tag}", real.contiguous(), r))
            else:
                real, _ = fused.detector_heatmap(cfg, sp, img)
                cases.append((f"detector {tag}", real.contiguous(), r))
    # Front-end training's feature staging (phase 11): 8 frames of 376 x
    # 1240 (the flagship preset's width, a multiple of 8) through the
    # network itself, r 3; and a random map of that shape.
    B, r = CHUNK, TRAIN_NMS_RADIUS
    heat = torch.rand(B, H, TRAIN_W, generator=gen, device=dev)
    heat = torch.round(heat * 64) / 64
    heat[:, :5, :7] = 1.99
    cases.append((f"random training {B}x{H}x{TRAIN_W} r{r}", heat, r))
    img = torch.from_numpy(stack[:B, :, :TRAIN_W].copy()).to(dev)
    with torch.no_grad():
        real, _ = sp(img[..., None])
    cases.append((f"train detector {B}x{H}x{TRAIN_W} r{r}",
                  real.contiguous(), r))
    return cases


def check_nms(torch, gen, dev, report, cfg, sp, stack):
    from gl_slam_tpu_torch.ops import nms as NM
    F = torch.nn.functional
    fr = cfg.frontend
    worst = 0.0
    for name, heat, r in nms_cases(torch, gen, dev, cfg, sp, stack):
        k = 2 * r + 1
        out = NM.nms_cuda(heat, r)
        ref = NM.nms_plain(heat, r)
        torch.cuda.synchronize()
        n_diff = int((out != ref).sum())
        err = float((out - ref).abs().max())
        worst = max(worst, err)
        # max and comparisons are exact: no tolerance.
        check(torch.equal(out, ref), f"nms {name}: {n_diff} pixels differ "
              f"from the plain version")
        survivors = int((out > 0).sum())
        check(survivors > 0, f"nms {name}: no survivor")
        # Detection through the kernel (on the card) and through the plain
        # version (the same map on the CPU): equal keypoints.
        got = NM.detect_keypoints(heat, fr.max_keypoints, fr.score_threshold,
                                  r)
        want = NM.detect_keypoints(heat.cpu(), fr.max_keypoints,
                                   fr.score_threshold, r)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              f"nms {name}: keypoints through the kernel differ from those "
              f"through the plain version")
        B, H, W = heat.shape
        # Window max: 2 x 2r compares per pixel (row then column pass); the
        # tie-break: 2 x 2r + 2r flag tests.
        flops = 10.0 * r * heat.numel()
        nbytes = 2 * 4 * heat.numel()
        plan = NM.nms_plan(B, H, W, r)
        row = dict(
            shape=name, radius=r, max_abs_err=err, plan=plan,
            pixels_differing=n_diff, survivors=survivors,
            keypoints=int(got[2].sum()),
            ms=time_ms(lambda: NM.nms_cuda(heat, r)),
            plain_ms=time_ms(lambda: NM.nms_plain(heat, r), reps=5),
            library_ms=time_ms(lambda: F.max_pool2d(
                heat[:, None], k, stride=1, padding=r)))
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes,
                                                 PEAK_F32_FLOPS)
        report.append(row)
        print(f"  nms {name}: {plan['strips']} strips x {plan['segments']} "
              f"segments of {plan['seg_rows']} rows, {plan['ctas']} CTAs; "
              f"equal, {survivors} survivors, "
              f"{row['keypoints']} keypoints; kernel {row['ms']:.4f} ms plain "
              f"{row['plain_ms']:.4f} ms max_pool2d {row['library_ms']:.4f} "
              f"ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
              flush=True)
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the flagship-width slice

STAGES = ("extract", "extract.nms", "prologue.match", "prologue.subpix",
          "prologue.essential", "track.match", "track.essential",
          "track.recover", "track.reobserve_window", "track.reobserve_covis",
          "track.reobserve", "track.pnp", "track.pose_lm",
          "track.insert_keyframe", "backend.ba", "backend.recycle")
OWN_KERNELS = {"attention": ("attention_kernel",),
               "assignment": ("assign_pass",),
               "nms": ("nms_kernel",)}
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def profile_run(torch, once):
    """Profile one run of the slice (bootstrap + chunks): device busy time
    and count of the device activities (kernels and copies), host time per
    pipeline stage from the stage markers, and the kernels with the most
    device time. The profiler slows the host, so stage times are read as
    shares of the profiled wall time. The profiler's raw records are read
    directly (`kineto_results.events()`), without building the Python
    event tree of `prof.events()`, which is slow at the 10^5-10^6 records
    of a run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    busy_us, n_kernels, by_name, launches = 0.0, 0, {}, 0
    stages, ba_ranges, syncs = {}, [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.is_user_annotation():
            if name not in STAGES:
                continue
            us = e.duration_ns() / 1e3
            st = stages.setdefault(name, dict(host_ms=0.0, calls=0,
                                              device_span_ms=0.0))
            if e.device_type() == cuda:
                # first kernel start to last kernel end inside the range
                st["device_span_ms"] += us / 1e3
            else:
                st["host_ms"] += us / 1e3
                st["calls"] += 1
                if name == "backend.ba":
                    ba_ranges.append((e.start_ns(), e.end_ns()))
        elif name in SYNC_CALLS:
            syncs.append(e.start_ns())
        elif e.device_type() == cuda:
            us = e.duration_ns() / 1e3
            busy_us += us
            n_kernels += 1
            t, c = by_name.get(name[:90], (0.0, 0))
            by_name[name[:90]] = (t + us, c + 1)
        elif name in ("cudaLaunchKernel", "cuLaunchKernel",
                      "cudaLaunchKernelExC"):
            launches += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    # Device time of the hand-written kernels, by the names in csrc/.
    own = {name: sum(t for k, (t, _) in by_name.items()
                     if any(f in k for f in fns)) / 1e3
           for name, fns in OWN_KERNELS.items()}
    # Busy and wall time of this one run. The profiler slows the host, so
    # this overstates the idle share of an unprofiled run.
    idle = 1.0 - busy_us / 1e6 / wall
    # Host synchronisations: all of the run, and those issued inside a BA
    # pass (the LM loop must need none).
    ba_syncs = sum(1 for t in syncs
                   if any(a <= t <= b for a, b in ba_ranges))
    out = dict(profiled_wall_s=wall, device_busy_s=busy_us / 1e6,
               device_idle_share=idle, kernels=n_kernels,
               launch_calls=launches, stages=stages,
               sync_calls=len(syncs), sync_calls_in_ba=ba_syncs,
               own_kernel_ms=own,
               top_kernels=[dict(name=k, ms=v[0] / 1e3, count=v[1])
                            for k, v in top])
    print(f"  profiled run: {wall:.3f} s wall, {n_kernels} device "
          f"activities, {launches} kernel launch calls, device "
          f"busy {busy_us / 1e6:.3f} s, idle share {idle:.3f}", flush=True)
    print(f"    host synchronisations: {len(syncs)} in the run, {ba_syncs} "
          f"inside BA passes")
    print("    hand-written kernels: " + ", ".join(
        f"{k} {v:.2f} ms ({100 * v / max(busy_us / 1e3, 1e-9):.1f} % of "
        "busy)"
        for k, v in own.items()))
    for k in STAGES:
        if k in stages:
            print(f"    {k}: host {stages[k]['host_ms']:.1f} ms over "
                  f"{stages[k]['calls']} calls, device span "
                  f"{stages[k]['device_span_ms']:.1f} ms")
    for row in out["top_kernels"][:8]:
        print(f"    {row['ms']:9.2f} ms {row['count']:6d}x {row['name']}")
    return out


def setup_slice(dev):
    """Flagship config (BA on, loop closing off), the committed weights on
    the card, and the rendered frames both tracker runs share."""
    import dataclasses

    from gl_slam_tpu_torch.config import flagship_config
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.train import e2e

    cfg = flagship_config()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, run_full_ba=True, loop_closing=False))
    check(cfg.frontend.subpix_source == "image", "centroid refinement")
    check(cfg.frontend.nms_radius == NMS_RADIUS, "nms radius")
    H, W = cfg.frontend.image_height, cfg.frontend.image_width
    t0 = time.perf_counter()
    sp, lg = e2e.load_flagship_frontend(os.path.join(ROOT, "checkpoints"),
                                        device=dev)
    scene = synthetic.make_scene(num_landmarks=20000, num_frames=N_FRAMES,
                                 height=H, width=W, seed=101,
                                 motion="forward_turn")
    stack = e2e.render_stack(scene, N_FRAMES, cfg.frontend.max_keypoints)
    print(f"setup (weights + {N_FRAMES} rendered frames) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, sp, lg, scene, stack


def ate_over(diag, scene, n):
    """ATE-RMSE (m) of the first n keyframes of a run's trajectory."""
    import numpy as np
    R, t, fidx = diag["R"][:n], diag["t"][:n], diag["frame_idx"][:n]
    c_est = np.einsum('kij,kj->ki', R.transpose(0, 2, 1), -t)
    c_gt = np.stack([-scene.poses_R[i].T @ scene.poses_t[i] for i in fidx])
    return float(np.sqrt(((c_est - c_gt) ** 2).sum(1).mean()))


def check_run(res, diag, n_frames, launches, want, what):
    import numpy as np
    o = diag["outputs"]
    check(np.isfinite(diag["R"]).all() and np.isfinite(diag["t"]).all(),
          f"{what}: non-finite keyframe pose")
    check(np.isfinite(o.R).all() and np.isfinite(o.t).all(),
          f"{what}: non-finite frame pose")
    check(res.num_rejected == 0 and res.num_keyframes == n_frames,
          f"{what}: frames not kept: {res.num_keyframes} keyframes of "
          f"{n_frames}")
    check(res.mean_matches > 300,
          f"{what}: mean matches {res.mean_matches} <= 300")
    check(res.ate_m <= 1.0, f"{what}: ATE {res.ate_m} m > 1 m")
    check(launches == want, f"{what}: launch counts {launches} != {want}")


def run_slice(torch, dev, details, cfg, sp, lg, scene, stack):
    """This slice's path: bootstrap + 3 chunks of 8 with BA every 8. Four
    runs through `run_learned_e2e`: warm-up, profiled, the counted one, and
    one with the BA diagnostics on (window reprojection before and after,
    live LM iterations, time per pass)."""
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.train import e2e

    def once(diag, ba_diag=False):
        return e2e.run_learned_e2e(sp, lg, scene, cfg, N_FRAMES, chunk=CHUNK,
                                   ba_every=CHUNK, device=dev, seed=0,
                                   stack=stack, diag_out=diag,
                                   ba_diag=ba_diag)

    t0 = time.perf_counter()
    warm, profiled = {}, {}
    once(warm)                               # warm-up: cuDNN plans, caches
    torch.cuda.synchronize()
    print(f"  warm-up run {time.perf_counter() - t0:.1f} s", flush=True)
    prof = details["profile"] = profile_run(torch, lambda: once(profiled))

    diag = {}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = once(diag)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"  bootstrap + {N_FRAMES - 2} frames (unprofiled): {run_s:.3f} s "
          f"wall", flush=True)
    o = diag["outputs"]
    want = expected_launches(N_CHUNKS)
    print(f"  frames {res.num_frames} keyframes {res.num_keyframes} "
          f"rejected {res.num_rejected} mean matches {res.mean_matches:.1f} "
          f"mean inliers {res.mean_inliers:.1f} ATE {res.ate_m:.4f} m "
          f"(first {N_FRAMES_NO_BA} keyframes "
          f"{ate_over(diag, scene, N_FRAMES_NO_BA):.4f} m) BA runs "
          f"{res.num_ba_runs} recoveries {diag['num_recoveries']} tracked "
          f"fps {res.fps:.2f} launches {launches} (expected {want})",
          flush=True)
    print(f"  tracking state {diag['state_bytes'] / 2**20:.1f} MiB, peak "
          f"allocated {peak / 2**20:.1f} MiB", flush=True)
    check_run(res, diag, N_FRAMES, launches, want, "BA-on slice")
    check(res.num_ba_runs == N_CHUNKS,
          f"{res.num_ba_runs} BA runs, expected {N_CHUNKS}")
    check(diag["num_recoveries"] == 0,
          f"{diag['num_recoveries']} health-check recoveries")
    check(prof["stages"].get("backend.ba", {}).get("calls") == N_CHUNKS,
          "the profiled run shows no backend.ba marker per BA pass")

    bd = {}
    res_d = once(bd, ba_diag=True)
    torch.cuda.synchronize()
    print(f"  with BA diagnostics: ATE {res_d.ate_m:.4f} m, tracked fps "
          f"{res_d.fps:.2f}, {cfg.ba.full_ba_iters} LM iterations issued per "
          f"pass", flush=True)
    check(res_d.num_ba_runs == N_CHUNKS and len(bd["ba_reproj"]) == N_CHUNKS,
          f"diagnostics of {len(bd['ba_reproj'])} BA passes, expected "
          f"{N_CHUNKS}")
    for i, ((before, after), iters, (host_ms, dev_ms)) in enumerate(zip(
            bd["ba_reproj"], bd["ba_lm_iters"], bd["ba_ms"])):
        print(f"  BA {i + 1}: window mean reprojection {before:.4f} px -> "
              f"{after:.4f} px, {iters} live LM iterations, host issue "
              f"{host_ms:.2f} ms, {dev_ms:.2f} ms between CUDA events "
              f"(pass + recycling + two diagnostic reprojections)",
              flush=True)
        check(math.isfinite(before) and math.isfinite(after),
              f"non-finite window reprojection error: {bd['ba_reproj']}")
        check(1 <= iters <= cfg.ba.full_ba_iters,
              f"BA {i + 1}: {iters} live LM iterations")
    details["slice"] = dict(
        config="flagship_config(), run_full_ba=True, ba_every=8, "
               "loop_closing=False, centroid subpix, NMS kernel, "
               "make_scene(seed=101, num_landmarks=20000, "
               "motion='forward_turn') 376x1241",
        frames=res.num_frames, keyframes=res.num_keyframes,
        rejected=res.num_rejected, mean_matches=res.mean_matches,
        mean_inliers=res.mean_inliers, ate_m=res.ate_m,
        ate_first_frames_m=ate_over(diag, scene, N_FRAMES_NO_BA),
        ate_first_pair_frames_m=ate_over(diag, scene, N_FRAMES_PAIR),
        mean_matches_first_pair_frames=float(
            o.num_matches[:N_FRAMES_PAIR - 2].mean()),
        fps=res.fps, run_wall_s=run_s, launches=launches,
        expected_launches=want, num_ba_runs=res.num_ba_runs,
        num_recoveries=diag["num_recoveries"],
        state_bytes=diag["state_bytes"], peak_allocated_bytes=peak,
        ba_diag_run=dict(ate_m=res_d.ate_m, fps=res_d.fps,
                         ba_reproj=bd["ba_reproj"],
                         ba_lm_iters=bd["ba_lm_iters"], ba_ms=bd["ba_ms"],
                         lm_iters_issued=cfg.ba.full_ba_iters),
        num_matches=o.num_matches.tolist(),
        num_inliers=o.num_inliers.tolist(),
        num_map_matches=o.num_map_matches.tolist())
    # the keyframe poses of the three plain runs of the same frames, for
    # phase 9's comparison; the counted run's map for phase 12
    return [(d["R"], d["t"]) for d in (warm, profiled, diag)], \
        diag["state"].map


def run_no_ba(torch, dev, details, cfg, sp, lg, scene, stack):
    """The earlier path (BA off) over the bootstrap + one chunk of the same
    frames, with its own launch-count check."""
    import dataclasses

    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.train import e2e

    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, run_full_ba=False))
    diag = {}
    _build.reset_launch_counts()
    res = e2e.run_learned_e2e(sp, lg, scene, cfg, N_FRAMES_NO_BA, chunk=CHUNK,
                              device=dev, seed=0,
                              stack=stack[:N_FRAMES_NO_BA], diag_out=diag)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = expected_launches(1)
    print(f"  frames {res.num_frames} keyframes {res.num_keyframes} mean "
          f"matches {res.mean_matches:.1f} ATE {res.ate_m:.4f} m BA runs "
          f"{res.num_ba_runs} tracked fps {res.fps:.2f} launches {launches} "
          f"(expected {want})", flush=True)
    details["slice_no_ba"] = dict(
        frames=res.num_frames, keyframes=res.num_keyframes,
        mean_matches=res.mean_matches, ate_m=res.ate_m, fps=res.fps,
        launches=launches, expected_launches=want)
    check_run(res, diag, N_FRAMES_NO_BA, launches, want, "BA-off slice")
    check(res.num_ba_runs == 0, "BA ran although it was switched off")


def run_pair(torch, dev, details, cfg, sp, lg, scene, stack):
    """The BA-on tracker with the pair sub-pixel head over the bootstrap +
    two chunks of the same frames: a counted run held to phase 3's guards,
    then a profiled run for the host time of `prologue.subpix`."""
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.train import e2e

    head = e2e.load_flagship_subpix(os.path.join(ROOT, "checkpoints"),
                                    device=dev)
    check(head is not None, "checkpoints/kspair_flagship.npz is missing")

    def once(diag):
        return e2e.run_learned_e2e(sp, lg, scene, cfg, N_FRAMES_PAIR,
                                   chunk=CHUNK, ba_every=CHUNK, device=dev,
                                   seed=0, stack=stack[:N_FRAMES_PAIR],
                                   diag_out=diag, subpix=head)

    diag = {}
    _build.reset_launch_counts()
    res = once(diag)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = expected_launches(N_CHUNKS_PAIR)
    cen = details["slice"]
    print(f"  frames {res.num_frames} keyframes {res.num_keyframes} "
          f"rejected {res.num_rejected} mean matches {res.mean_matches:.1f} "
          f"(centroid run, same frames: "
          f"{cen['mean_matches_first_pair_frames']:.1f}) ATE "
          f"{res.ate_m:.4f} m (centroid run, same frames: "
          f"{cen['ate_first_pair_frames_m']:.4f} m) BA runs "
          f"{res.num_ba_runs} recoveries {diag['num_recoveries']} tracked "
          f"fps {res.fps:.2f} launches {launches} (expected {want})",
          flush=True)
    check_run(res, diag, N_FRAMES_PAIR, launches, want, "pair-mode slice")
    check(res.num_ba_runs == N_CHUNKS_PAIR,
          f"pair mode: {res.num_ba_runs} BA runs, expected {N_CHUNKS_PAIR}")
    check(diag["num_recoveries"] == 0,
          f"pair mode: {diag['num_recoveries']} health-check recoveries")
    check(diag["state"].prev_patches is not None,
          "pair mode: the state carries no patches")
    prof = profile_run(torch, lambda: once({}))
    sub = prof["stages"].get("prologue.subpix", {})
    check(sub.get("calls") == N_CHUNKS_PAIR,
          f"pair mode: {sub.get('calls')} prologue.subpix markers, expected "
          f"{N_CHUNKS_PAIR}")
    print(f"  prologue.subpix: host {sub['host_ms']:.2f} ms over "
          f"{sub['calls']} chunks (profiled run)", flush=True)
    details["slice_pair"] = dict(
        config="as phase 3, with PairSubpixHead (kspair_flagship.npz)",
        frames=res.num_frames, keyframes=res.num_keyframes,
        rejected=res.num_rejected, mean_matches=res.mean_matches,
        mean_inliers=res.mean_inliers, ate_m=res.ate_m, fps=res.fps,
        num_ba_runs=res.num_ba_runs, num_recoveries=diag["num_recoveries"],
        launches=launches, expected_launches=want,
        centroid_same_frames=dict(
            ate_m=cen["ate_first_pair_frames_m"],
            mean_matches=cen["mean_matches_first_pair_frames"]),
        subpix_host_ms=sub["host_ms"], profile=prof,
        num_matches=diag["outputs"].num_matches.tolist())


def run_done(torch, dev, details):
    """The round's Done scenario, counted and unprofiled: the flagship eval
    (evals.flagship_eval, the code of scripts/eval_flagship_torch.py)
    with loop closing on, held to the bounds of the flagship eval's test,
    the detection cadence and the launch counts the path implies: the
    tracker's, plus per detection 36 attention calls and one assignment
    call at the detector's shapes."""
    import numpy as np

    from gl_slam_tpu_torch.config import flagship_config
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.train import evals

    cfg = flagship_config()
    check(cfg.runtime.loop_closing, "flagship_config() has loop closing off")
    n_chunks = (DONE_FRAMES - 2) // CHUNK
    checks = evals.loop_checks_implied(cfg, DONE_FRAMES, CHUNK)
    want = expected_launches(n_chunks)
    want["attention"] += ATTN_PER_DETECTION * len(checks)
    want["assignment"] += ASSIGN_KERNELS_PER_CALL * len(checks)
    diag = {}
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    rep = evals.flagship_eval(os.path.join(ROOT, "checkpoints"),
                              frames=DONE_FRAMES, device=dev, warmup=False,
                              diag_out=diag)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    wall = time.perf_counter() - t0
    print(f"  frames {rep['num_frames']} keyframes {rep['num_keyframes']} "
          f"rejected {rep['num_rejected_frames']} mean matches "
          f"{rep['mean_matches']} ATE {rep['ate_rmse_m']} m "
          f"({rep['ate_pct_of_trajectory']} % of the trajectory) BA runs "
          f"{rep['num_ba_runs']} recoveries {rep['num_recoveries']} loop "
          f"checks at frames {rep['loop_checks']} (implied {checks}) "
          f"closures {rep['loop_closures']} tracked fps "
          f"{rep['fps_same_run']} launches {launches} (expected {want}); "
          f"render {rep['render_s']} s, phase {wall:.1f} s", flush=True)
    for c in diag["loop_checks"]:
        d = c["det"]
        print(f"  detection at frame {c['frames']}: host {c['host_ms']:.1f} "
              f"ms to issue; ok {bool(d.ok)}, candidates "
              f"{int(d.region_votes)} of {int(d.n_vis)} retrieved, "
              f"{int(d.n_good)} matches, {int(d.num_inliers)} PnP inliers",
              flush=True)
    for e in rep["loop_events"]:
        print(f"  closure: {e}", flush=True)
    o = diag["outputs"]
    check(np.isfinite(diag["R"]).all() and np.isfinite(diag["t"]).all()
          and np.isfinite(o.R).all() and np.isfinite(o.t).all(),
          "Done run: non-finite pose")
    check(rep["num_frames"] >= 100, f"Done run: {rep['num_frames']} frames")
    check(rep["ate_pct_of_trajectory"] <= 0.5,
          f"Done run: ATE {rep['ate_pct_of_trajectory']} % of the "
          f"trajectory > 0.5 %")
    check(rep["num_keyframes"] >= 0.97 * rep["num_frames"],
          f"Done run: {rep['num_keyframes']} keyframes of "
          f"{rep['num_frames']} frames")
    check(rep["mean_matches"] > 300,
          f"Done run: mean matches {rep['mean_matches']} <= 300")
    check(rep["num_ba_runs"] >= 5 and rep["num_ba_runs"] == n_chunks,
          f"Done run: {rep['num_ba_runs']} BA runs, expected {n_chunks}")
    check(rep["num_recoveries"] == 0,
          f"Done run: {rep['num_recoveries']} recoveries")
    check(rep["loop_checks"] == checks,
          f"Done run: loop checks {rep['loop_checks']} != {checks}")
    check(rep["loop_closures"] == len(rep["loop_events"]),
          "Done run: closures and loop events disagree")
    check(launches == want, f"Done run: launch counts {launches} != {want}")
    details["done"] = dict(report=rep, launches=launches,
                           expected_launches=want, phase_wall_s=wall,
                           num_matches=o.num_matches.tolist())


# ---------------------------------------------------------------------------
# Phase 9: the tracker options on the chunked route

# (name, map overrides, runtime overrides) of each run, in order
OPTION_RUNS = (
    ("batched", dict(reobs_mode="batched"), {}),
    ("merged", dict(reobs_mode="merged"), {}),
    ("pnp", {}, dict(tracker="pnp")),
    ("gated", {}, dict(every_frame_keyframe=False)),
    ("gated-1e6", {}, dict(every_frame_keyframe=False, gt_mag_filter=1e6,
                           gt_rot_filter=1e6)),
)


def pose_gap(a, b):
    """Largest difference between two runs' keyframe poses: (rotation
    entries, translation m)."""
    import numpy as np
    return (float(np.abs(a[0] - b[0]).max()),
            float(np.abs(a[1] - b[1]).max()))


def run_options(torch, dev, details, cfg, sp, lg, scene, stack, slice_poses):
    """The tracker options, one run each over phase 3's frames and setup
    (bootstrap + 3 chunks of 8, BA every 8, centroid refinement, loop
    closing off, seed 0): the batched and the merged re-observation modes,
    the PnP tracker, motion gating at the default filters (every frame of
    this ~1 m-per-frame scene passes them) and at 1e6 (no frame after the
    bootstrap passes; every frame but a chunk's first takes the recovery
    branch). A warm-up run of the batched mode over one chunk comes first,
    and the batched run is profiled once more after its counted run."""
    import dataclasses

    import numpy as np

    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.train import e2e

    n_tracked = N_FRAMES - 2
    spread = max(max(pose_gap(a, b)) for i, a in enumerate(slice_poses)
                 for b in slice_poses[i + 1:])
    out = {}
    for name, map_kw, rt_kw in OPTION_RUNS:
        ocfg = dataclasses.replace(
            cfg, map=dataclasses.replace(cfg.map, **map_kw),
            runtime=dataclasses.replace(cfg.runtime, **rt_kw))

        def once(diag, n=N_FRAMES):
            return e2e.run_learned_e2e(sp, lg, scene, ocfg, n, chunk=CHUNK,
                                       ba_every=CHUNK, device=dev, seed=0,
                                       stack=stack[:n], diag_out=diag)

        if name == "batched":
            once({}, N_FRAMES_NO_BA)      # first calls at the batch-2 shapes
        diag = {}
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = once(diag)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        want = expected_launches(N_CHUNKS, ocfg.map.reobs_mode)
        o = diag["outputs"]
        rec = diag["recovery_frames"]
        # the bootstrap's and the prologues' matcher calls set aside
        per_frame = {
            "attention": (launches["attention"] - 18 * (1 + N_CHUNKS))
            / n_tracked,
            "assignment": (launches["assignment"] - ASSIGN_KERNELS_PER_CALL
                           * (1 + N_CHUNKS)) / n_tracked}
        gap = pose_gap((diag["R"], diag["t"]), slice_poses[-1]) \
            if res.num_keyframes == N_FRAMES else None
        print(f"  {name}: frames {res.num_frames} keyframes "
              f"{res.num_keyframes} rejected {res.num_rejected} recovery-"
              f"branch frames {len(rec)} mean matches "
              f"{res.mean_matches:.1f} map matches "
              f"{float(o.num_map_matches.mean()):.1f} ATE {res.ate_m:.4f} m "
              f"BA runs {res.num_ba_runs} recoveries "
              f"{diag['num_recoveries']} tracked fps {res.fps:.2f} "
              f"({wall:.1f} s) launches {launches} (expected {want}; per "
              f"tracked frame past the prologues {per_frame})"
              + ("" if gap is None else f"; keyframe poses vs phase 3: "
                 f"{gap[0]:.3g} (R) {gap[1]:.3g} m (t)"), flush=True)
        check(np.isfinite(o.R).all() and np.isfinite(o.t).all()
              and np.isfinite(diag["R"]).all()
              and np.isfinite(diag["t"]).all(), f"{name}: non-finite pose")
        st = diag["state"]
        check(all(bool(torch.isfinite(x).all()) for x in
                  (*st.map, *st[1:]) if torch.is_tensor(x)
                  and x.is_floating_point()), f"{name}: non-finite state")
        check(diag["num_recoveries"] == 0,
              f"{name}: {diag['num_recoveries']} health-check recoveries")
        check(res.num_ba_runs == N_CHUNKS,
              f"{name}: {res.num_ba_runs} BA runs, expected {N_CHUNKS}")
        if name == "gated-1e6":
            check(launches == want,
                  f"{name}: launch counts {launches} != {want}")
            check(res.num_keyframes == 2 and res.num_rejected == n_tracked,
                  f"{name}: {res.num_keyframes} keyframes, "
                  f"{res.num_rejected} rejected")
            want_rec = [2 + i for i in range(n_tracked) if i % CHUNK]
            check(rec == want_rec, f"{name}: recovery-branch frames {rec}, "
                  f"expected {want_rec}")
        else:
            check_run(res, diag, N_FRAMES, launches, want, name)
            check(rec == [], f"{name}: recovery-branch frames {rec}")
        if name == "gated":
            # every frame passes the default filters: the run is phase 3's
            check(max(gap) <= spread,
                  f"{name}: keyframe poses {gap} away from phase 3's run, "
                  f"whose own runs differ by {spread}")
        out[name] = dict(
            map=map_kw, runtime=rt_kw, frames=res.num_frames,
            keyframes=res.num_keyframes, rejected=res.num_rejected,
            recovery_frames=rec, mean_matches=res.mean_matches,
            mean_map_matches=float(o.num_map_matches.mean()),
            mean_inliers=res.mean_inliers, ate_m=res.ate_m, fps=res.fps,
            run_wall_s=wall, num_ba_runs=res.num_ba_runs,
            num_recoveries=diag["num_recoveries"], launches=launches,
            expected_launches=want, launches_per_tracked_frame=per_frame,
            pose_gap_to_phase3=gap)
        if name == "batched":
            out[name]["profile"] = profile_run(torch, lambda: once({}))
    out["phase3_spread"] = spread
    print(f"  phase 3's three plain runs differ by up to {spread:.3g} in "
          f"their keyframe poses", flush=True)
    details["options"] = out


class FrameWaits:
    """Within the block, every frame the command line fetches is timed on
    the host (`cli._open_dataset`'s frame function wrapped), and the
    native loader's frame counter starts from 0: `ms_per_frame`, `frames`
    and `delivered` after it."""

    def __enter__(self):
        from gl_slam_tpu_torch import cli
        from gl_slam_tpu_torch.runtime import native_lib
        self._cli, self._lib = cli, native_lib
        self._orig = cli._open_dataset
        self.waits = []

        def wrapped(args):
            src, K, gt_R, gt_t, frame, gate = self._orig(args)

            def timed(i):
                t0 = time.perf_counter()
                img = frame(i)
                self.waits.append(time.perf_counter() - t0)
                return img
            return src, K, gt_R, gt_t, timed, gate

        cli._open_dataset = wrapped
        native_lib.reset_frame_count()
        return self

    def __exit__(self, *exc):
        self._cli._open_dataset = self._orig
        self.frames = len(self.waits)
        self.delivered = self._lib.DELIVERED["frames"]
        self.ms_per_frame = 1e3 * sum(self.waits) / max(self.frames, 1)
        return False


# The host wait for frames in turns (phase 7): after the counted run on
# the native loader, the command line over the first TURN_FRAMES frames (a
# bootstrap and two chunks) on PIL, then on the loader again.
TURN_FRAMES = 18
TURN_ORDER = ("pil", "native")


def frame_waits_in_turns(torch, argv, out):
    """[(reader, host ms a frame waiting for frames)] of the command line
    `argv` cut to TURN_FRAMES frames, one run per entry of TURN_ORDER
    (PIL by `native_lib.available` reading False), each into a directory of
    its own under `out`'s parent, removed after."""
    import contextlib
    import io
    import shutil

    from gl_slam_tpu_torch import cli
    from gl_slam_tpu_torch.runtime import native_lib

    cut = list(argv)
    cut[cut.index("--last-frame") + 1] = str(TURN_FRAMES - 1)
    available = native_lib.available
    turns = []
    for i, reader in enumerate(TURN_ORDER):
        d = f"{out}_turn{i}"
        if reader == "pil":
            native_lib.available = lambda: False
        try:
            with contextlib.redirect_stdout(io.StringIO()), \
                    FrameWaits() as fw:
                rc = cli.main(cut[:-1] + [d])
            torch.cuda.synchronize()
        finally:
            native_lib.available = available
            shutil.rmtree(d, ignore_errors=True)
        check(rc == 0, f"command line on {reader} ({TURN_FRAMES} frames) "
              f"failed")
        check(fw.delivered == (TURN_FRAMES if reader == "native" else 0),
              f"command line on {reader}: the loader delivered "
              f"{fw.delivered} frames")
        turns.append((reader, fw.ms_per_frame))
    return turns


def native_loader_state():
    """(built, message): whether the native PNG loader builds and loads
    on this machine (g++ and the C++ runtime; its PNG reader needs no
    libpng or zlib). Phases 7 and 8 fail without it."""
    from gl_slam_tpu_torch.runtime import native_lib
    if native_lib.available():
        return True, ("native PNG loader built "
                      f"({native_lib.library_path('loader')})")
    err = (native_lib.build_error() or "").strip().splitlines()
    why = next((ln for ln in err if "error" in ln.lower()),
               err[0] if err else "")
    return False, f"native PNG loader not built on this machine ({why})"


def run_cli(torch, dev, details):
    """The chunked route through the entry point a user calls:
    `gl_slam_tpu_torch.cli.main(["run", ...])` on the card (no --device)
    over a KITTI-layout directory of 8-bit PNG frames, which it writes
    and returns (phase 8 reads it too). The launch counts exclude the
    warm-up chunk (ChunkedPipeline.warmup, wrapped here to count its
    launches and to keep the pipeline for the per-frame outputs)."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from gl_slam_tpu_torch import cli
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.io.kitti import write_kitti_sequence
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.slam.chunk_driver import ChunkedPipeline

    data = os.path.join(ROOT, "chiprun_out", "kitti_cli")
    out = os.path.join(ROOT, "chiprun_out", "cli_out")
    for d in (data, out):
        shutil.rmtree(d, ignore_errors=True)
    scene = synthetic.make_scene(num_landmarks=20000, num_frames=CLI_FRAMES,
                                 height=376, width=1241, seed=101,
                                 motion="forward_turn")
    t0 = time.perf_counter()
    write_kitti_sequence(data, scene, CLI_FRAMES, max_keypoints=N_KPTS)
    write_s = time.perf_counter() - t0

    seen = {}
    warmup = ChunkedPipeline.warmup

    def counted_warmup(self, images):
        before = dict(_build.LAUNCHES)
        warmup(self, images)
        seen["pipe"] = self
        seen["warmup"] = {k: v - before[k] for k, v in _build.LAUNCHES.items()}

    chunk, ba_every = CHUNK, CHUNK
    argv = ["run", "--dataset", data, "--frontend", "superpoint",
            "--preset", "flagship", "--subpix", "single",
            "--weights", os.path.join(ROOT, "checkpoints"),
            "--first-frame", "0", "--last-frame", str(CLI_FRAMES - 1),
            "--chunk", str(chunk), "--ba-every", str(ba_every), "--out", out]
    native, native_msg = native_loader_state()
    print(f"  {native_msg}", flush=True)
    check(native, f"command line: {native_msg}")
    stdout = io.StringIO()
    ChunkedPipeline.warmup = counted_warmup
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout), FrameWaits() as fw:
            rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        ChunkedPipeline.warmup = warmup
    wall = time.perf_counter() - t0
    check(rc == 0, f"command line: exit code {rc}")
    check("pipe" in seen, "command line: no warm-up chunk ran")
    launches = {k: v - seen["warmup"][k] for k, v in _build.LAUNCHES.items()}
    check(fw.frames == CLI_FRAMES, f"command line: {fw.frames} frame "
          f"fetches for {CLI_FRAMES} frames")
    check(fw.delivered == CLI_FRAMES,
          f"command line: the native loader delivered {fw.delivered} "
          f"frames of {CLI_FRAMES} fed")
    waits = {"native": fw.ms_per_frame}
    turns = frame_waits_in_turns(torch, argv, out)
    print(f"  host wait for frames: native {fw.ms_per_frame:.2f} ms a frame "
          f"over {CLI_FRAMES} frames; in turns over the first {TURN_FRAMES} "
          f"frames: " + ", ".join(f"{k} {v:.2f} ms" for k, v in turns),
          flush=True)
    waits["turns"] = turns
    report = json.loads(stdout.getvalue())
    want = expected_launches(CLI_CHUNKS)
    pipe = seen["pipe"]
    o = pipe.stacked_outputs()
    n_real = CLI_FRAMES - 2
    real = np.arange(CLI_CHUNKS * CHUNK) < n_real
    real_matches = float(o.num_matches[real].mean())
    R, t, fidx = pipe.trajectory()
    c_est = np.einsum('kij,kj->ki', R.transpose(0, 2, 1), -t)
    c_gt = np.stack([-scene.poses_R[i].T @ scene.poses_t[i] for i in fidx])
    err = np.sqrt(((c_est - c_gt) ** 2).sum(1))
    ate_26 = float(np.sqrt((err[:N_FRAMES] ** 2).mean()))
    want_ba = CLI_CHUNKS // max(ba_every // chunk, 1)
    print(f"  wrote {CLI_FRAMES} PNG frames in {write_s:.1f} s; report "
          f"{json.dumps(report)}", flush=True)
    print(f"  frames fed {report['frames_fed']} tracked "
          f"{report['frames_tracked']} rejected {report['frames_rejected']} "
          f"(padding {int((~real).sum())}); mean matches over the real "
          f"frames {real_matches:.1f}; ATE {report['ate_rmse_m']} m, over "
          f"the first {N_FRAMES} keyframes {ate_26:.4f} m (phase 3, PNG-free "
          f"frames of the {N_FRAMES}-frame scene: "
          f"{details['slice']['ate_m']:.4f} m); BA runs {report['ba_runs']} "
          f"(expected {want_ba}) recoveries {pipe.num_recoveries}; "
          f"fps_incl_io {report['fps_incl_io']}; launches after the warm-up "
          f"{launches} (expected {want}), warm-up {seen['warmup']}; phase "
          f"{wall:.1f} s", flush=True)
    traj = np.loadtxt(os.path.join(out, "trajectory.txt"))
    check(report["subpix"] == "single", f"sub-pixel mode {report['subpix']}")
    check(report["frames_fed"] == CLI_FRAMES
          and report["frames_tracked"] == CLI_FRAMES,
          f"command line: {report['frames_fed']} frames fed, "
          f"{report['frames_tracked']} tracked, expected {CLI_FRAMES}")
    check(report["frames_rejected"] == CLI_CHUNKS * CHUNK - n_real,
          f"command line: {report['frames_rejected']} frames rejected")
    check(bool((o.frame_ok == real).all()),
          f"command line: frame_ok {o.frame_ok.tolist()}")
    check(np.isfinite(R).all() and np.isfinite(t).all()
          and np.isfinite(o.R).all() and np.isfinite(o.t).all(),
          "command line: non-finite pose")
    check(report["ate_rmse_m"] < 1.0,
          f"command line: ATE {report['ate_rmse_m']} m >= 1 m")
    check(real_matches > 300, f"command line: mean matches over the real "
          f"frames {real_matches} <= 300")
    check(pipe.num_recoveries == 0,
          f"command line: {pipe.num_recoveries} recoveries")
    check(report["ba_runs"] == want_ba,
          f"command line: {report['ba_runs']} BA runs, expected {want_ba}")
    check(traj.shape == (CLI_FRAMES, 12),
          f"trajectory.txt has shape {traj.shape}")
    check(os.path.exists(os.path.join(out, "map.json")), "no map.json")
    check(launches == want,
          f"command line: launch counts {launches} != {want}")
    details["cli"] = dict(
        config=f"gl-slam-tpu-torch {' '.join(argv[:-2])} (scene "
               f"make_scene(seed=101, num_landmarks=20000, "
               f"motion='forward_turn', num_frames={CLI_FRAMES}))",
        report=report, mean_matches_real_frames=real_matches,
        ate_first_frames_m=ate_26, phase3_ate_m=details["slice"]["ate_m"],
        num_recoveries=pipe.num_recoveries, launches=launches,
        expected_launches=want, warmup_launches=seen["warmup"],
        png_write_s=write_s, phase_wall_s=wall,
        native_loader=native_msg, frames_delivered_by_loader=fw.delivered,
        frame_wait_ms_per_frame=waits,
        num_matches=o.num_matches.tolist(),
        frame_ok=o.frame_ok.tolist())
    return data


def run_cli_capture(torch, argv):
    """`cli.main(argv)` on the card with its report captured, the launch
    counters set to 0 just before and read just after ->
    (report, TrackingPipeline, launches, wall s)."""
    import contextlib
    import io

    from gl_slam_tpu_torch import cli
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.slam.pipeline import TrackingPipeline

    seen = {}
    finish = TrackingPipeline.finish

    def keep(self):
        seen["pipe"] = self
        finish(self)

    stdout = io.StringIO()
    TrackingPipeline.finish = keep
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout), FrameWaits() as fw:
            rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        TrackingPipeline.finish = finish
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check(rc == 0, f"{' '.join(argv[:4])}: exit code {rc}")
    seen["pipe"].frame_waits = fw
    return json.loads(stdout.getvalue()), seen["pipe"], launches, wall


def check_per_frame_artifacts(out, report, what, steps):
    """trajectory.txt (one row per keyframe), metrics.jsonl (one row per
    tracked step), map.json, the live snapshot and the state checkpoint
    (its keyframe count) -> the names present."""
    import numpy as np
    n = report["frames_tracked"]
    traj = np.loadtxt(os.path.join(out, "trajectory.txt")).reshape(-1, 12)
    check(traj.shape == (n, 12) and np.isfinite(traj).all(),
          f"{what}: trajectory.txt has shape {traj.shape}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = f.read().splitlines()
    check(len(rows) == steps, f"{what}: {len(rows)} metrics rows, expected "
          f"{steps}")
    with open(os.path.join(out, "map.json")) as f:
        check(len(json.load(f)["keyframe_centers"]) == n,
              f"{what}: map.json keyframes")
    with open(os.path.join(out, "live", "live.json")) as f:
        check(len(json.load(f)["keyframe_centers"]) >= 2,
              f"{what}: live.json holds no trajectory")
    with np.load(os.path.join(out, "ckpt", "state.npz")) as z:
        check(int(z["map.num_kf"]) == n,
              f"{what}: the checkpoint holds {int(z['map.num_kf'])} "
              f"keyframes, expected {n}")
    return sorted(os.listdir(out)) + sorted(
        os.path.join("live", f) for f in os.listdir(os.path.join(out,
                                                                 "live")))


def run_per_frame(torch, details, data):
    """This slice's path, the command line's per-frame route, on phase 7's
    KITTI layout: `--frontend superpoint --per-frame --preset flagship`
    counted and unprofiled, then profiled over its first
    PF_PROFILE_FRAMES frames; then `--frontend harris` at full width (its
    patch descriptors are 64-d) and the default oracle route, each with
    `--live-viz 8 --checkpoint`. Returns the learned run's launches."""
    import shutil

    import numpy as np

    ckpt = os.path.join(ROOT, "checkpoints")
    outs = {k: os.path.join(ROOT, "chiprun_out", f"pf_{k}")
            for k in ("superpoint", "profile", "harris", "oracle")}
    for d in outs.values():
        shutil.rmtree(d, ignore_errors=True)

    def argv(kind, last, *extra):
        return ["run", "--dataset", data, "--weights", ckpt,
                "--first-frame", "0", "--last-frame", str(last),
                "--out", outs[kind], *extra]

    learned = ("--frontend", "superpoint", "--per-frame", "--preset",
               "flagship")
    report, pipe, launches, wall = run_cli_capture(
        torch, argv("superpoint", CLI_FRAMES - 1, *learned))
    gated = report["frames_gated"]
    steps = CLI_FRAMES - 2 - gated
    want = expected_launches_per_frame(steps)
    o = pipe.stacked_outputs()
    matches = float(o.num_matches[1:].mean())
    inliers = float(o.num_inliers[1:].mean())
    print(f"  superpoint --per-frame: report {json.dumps(report)}",
          flush=True)
    native, native_msg = native_loader_state()
    fw = pipe.frame_waits
    fed = CLI_FRAMES - gated
    print(f"  {native_msg}: {fw.frames} frames fetched, host wait "
          f"{fw.ms_per_frame:.2f} ms a frame, {fw.delivered} delivered by "
          f"the native loader", flush=True)
    check(native, f"per-frame route: {native_msg}")
    check(fw.frames == fed, f"per-frame route: {fw.frames} frame fetches "
          f"for {fed} frames fed")
    # every frame up to --last-frame comes off the loader's ring once; a
    # frame the motion gate skips is dropped there
    check(fw.delivered == CLI_FRAMES,
          f"per-frame route: the native loader delivered {fw.delivered} "
          f"frames of {CLI_FRAMES}")
    print(f"  frames tracked {report['frames_tracked']} of {CLI_FRAMES} "
          f"({gated} gated), rejected {int((~o.frame_ok).sum())}; mean "
          f"matches {matches:.1f}, inliers {inliers:.1f}; ATE "
          f"{report['ate_rmse_m']} m; BA runs {report['map']['num_ba_runs']}"
          f" recoveries {pipe.num_recoveries}; fps_incl_features "
          f"{report['fps_incl_features']}; launches {launches} (expected "
          f"{want}); phase run {wall:.1f} s", flush=True)
    check(report["frames_tracked"] == CLI_FRAMES - gated,
          f"per-frame route: {report['frames_tracked']} frames tracked of "
          f"{CLI_FRAMES - gated} not gated")
    check(np.isfinite(o.R).all() and np.isfinite(o.t).all(),
          "per-frame route: non-finite pose")
    check(report["ate_rmse_m"] <= 1.0,
          f"per-frame route: ATE {report['ate_rmse_m']} m > 1 m")
    check(pipe.num_recoveries == 0,
          f"per-frame route: {pipe.num_recoveries} recoveries")
    check(matches > 100, f"per-frame route: mean matches {matches}")
    check(launches == want,
          f"per-frame route: launch counts {launches} != {want}")
    for f in ("trajectory.txt", "metrics.jsonl", "map.json"):
        check(os.path.exists(os.path.join(outs["superpoint"], f)),
              f"per-frame route: no {f}")

    prof = profile_run(torch, lambda: run_cli_capture(
        torch, argv("profile", PF_PROFILE_FRAMES - 1, *learned)))
    match_calls = prof["stages"].get("track.match", {}).get("calls")
    check(match_calls == PF_PROFILE_FRAMES - 1,
          f"per-frame profile: {match_calls} track.match markers, expected "
          f"{PF_PROFILE_FRAMES - 1}")

    runs = {}
    for kind, args in (
            ("harris", argv("harris", CLI_FRAMES - 1, "--frontend", "harris",
                            "--preset", "flagship", "--desc-dim", "64",
                            "--live-viz", "8", "--checkpoint")),
            ("oracle", ["run", "--weights", ckpt, "--out", outs["oracle"],
                        "--live-viz", "8", "--checkpoint"])):
        rep, p, lc, w = run_cli_capture(torch, args)
        n_frames = CLI_FRAMES if kind == "harris" else ORACLE_FRAMES
        st = n_frames - 2 - rep["frames_gated"]
        # Harris extracts once per frame through the NMS kernel (r 4); the
        # oracle launches no kernel; mutual NN matches both
        want_k = {"attention": 0, "assignment": 0,
                  "nms": st + 2 if kind == "harris" else 0}
        files = check_per_frame_artifacts(outs[kind], rep, kind, st)
        print(f"  {kind}: frames tracked {rep['frames_tracked']} of "
              f"{n_frames} ({rep['frames_gated']} gated); ATE "
              f"{rep['ate_rmse_m']} m (aligned {rep['ate_rmse_aligned_m']} "
              f"m); BA runs {rep['map']['num_ba_runs']} recoveries "
              f"{p.num_recoveries}; fps_incl_features "
              f"{rep['fps_incl_features']}; launches {lc} (expected "
              f"{want_k}); {w:.1f} s; artifacts {files}", flush=True)
        check(lc == want_k, f"{kind}: launch counts {lc} != {want_k}")
        check(p.num_recoveries == 0, f"{kind}: {p.num_recoveries} recoveries")
        if kind == "oracle":
            check(rep["frames_tracked"] == n_frames,
                  f"oracle: {rep['frames_tracked']} of {n_frames} tracked")
            check(rep["ate_rmse_m"] <= 1.0,
                  f"oracle: ATE {rep['ate_rmse_m']} m > 1 m")
        runs[kind] = dict(report=rep, launches=lc, expected_launches=want_k,
                          recoveries=p.num_recoveries, wall_s=w,
                          artifacts=files)
    details["per_frame"] = dict(
        config=f"gl-slam-tpu-torch {' '.join(argv('superpoint', 0)[:2])} "
               f"<phase 7's layout> {' '.join(learned)} --first-frame 0 "
               f"--last-frame {CLI_FRAMES - 1}",
        report=report, mean_matches=matches, mean_inliers=inliers,
        num_recoveries=pipe.num_recoveries, launches=launches,
        expected_launches=want, wall_s=wall, profile=prof,
        profile_frames=PF_PROFILE_FRAMES, native_loader=native_msg,
        frames_delivered_by_loader=fw.delivered,
        frame_wait_ms_per_frame=fw.ms_per_frame,
        num_matches=o.num_matches.tolist(),
        frame_ok=o.frame_ok.tolist(), **runs)
    for d in outs.values():            # the checkpoints: keep what comes
        shutil.rmtree(d, ignore_errors=True)     # back small
    return launches


# ---------------------------------------------------------------------------
# Phase 10: multi-stream tracking on the stream axis

def _stream_draws(torch, dev, n_streams, n_chunks, hyp, seed):
    """Each stream's RANSAC draws from a generator of its own: the
    bootstrap's (S, hyp, 8) and each chunk's (S, T, hyp, 8)."""
    boot, chunks = [], [[] for _ in range(n_chunks)]
    for s in range(n_streams):
        g = torch.Generator(device=dev).manual_seed(seed + s)
        boot.append(torch.rand((hyp, 8), generator=g, device=dev))
        for c in range(n_chunks):
            chunks[c].append(torch.rand((CHUNK, hyp, 8), generator=g,
                                        device=dev))
    return torch.stack(boot), [torch.stack(c) for c in chunks]


def _gt_scale(scene, o):
    import numpy as np
    c = [-scene.poses_R[i].T @ scene.poses_t[i] for i in (o, o + 1)]
    return float(np.linalg.norm(c[1] - c[0]))


def _camera(K, s):
    """Stream s's camera: K with f moved by MS_F_MOVE[s] and the principal
    point by MS_C_MOVE[s] (relative)."""
    import numpy as np
    K = np.array(K, np.float64)
    K[[0, 1], [0, 1]] *= 1 + MS_F_MOVE[s]
    K[[0, 1], [2, 2]] *= 1 + MS_C_MOVE[s]
    return K


def _stream_ate(scene, R, t, n, o):
    """ATE (m) of a stream's first n keyframes (its frame i is scene frame
    o + i) against the ground truth in the camera coordinates of scene
    frame o, where the stream's bootstrap puts its first keyframe."""
    import numpy as np
    c_est = np.einsum('kij,kj->ki', R[:n].transpose(0, 2, 1), -t[:n])
    R0, t0 = scene.poses_R[o], scene.poses_t[o]
    c_gt = np.stack([R0 @ (-scene.poses_R[o + i].T @ scene.poses_t[o + i])
                     + t0 for i in range(n)])
    return float(np.sqrt(((c_est - c_gt) ** 2).sum(1).mean()))


def run_multistream(torch, dev, details, cfg, sp, lg, scene, stack):
    """S streams through MultiStreamTracker's bootstrap, multi-stream
    chunks (slam/fused.build_multistream_chunk_fn) and the tracker's
    stream-batched window BA; each stream held to its own single-stream
    run (the same extraction batches, draws and window). Then this slice's
    path: four streams, each with its own camera (K (S, 3, 3)), and last
    16 streams. Returns the launches of the distinct-K run."""
    import numpy as np

    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.parallel.multistream import MultiStreamTracker
    from gl_slam_tpu_torch.slam import ba as ba_mod
    from gl_slam_tpu_torch.slam import frontend, fused
    from gl_slam_tpu_torch.slam.state import _at

    hyp = cfg.geometry.essential_hypotheses
    frames = torch.from_numpy(stack).to(dev)
    extract = fused.build_extract_fn(cfg, sp)
    win_kf = CHUNK + cfg.ba.full_ba_overlap

    # A stream's view: (its frames, the index of its frame 0 in them, the
    # scene frame of its frame 0).
    def shared(offsets):
        return [(frames, o, o) for o in offsets]

    def boot_feats(views, group):
        """Features of each stream's frames 0 and 1, one extraction per
        group of streams -> two (S, N, ...) tuples."""
        per = []
        for j in range(0, len(views), group):
            imgs = torch.stack([fr[i0 + i] for fr, i0, _ in views[j:j + group]
                                for i in (0, 1)])
            per.append(extract(imgs))
        kp, de, va = (torch.cat([f[k] for f in per]).unflatten(0, (-1, 2))
                      for k in range(3))
        return (kp[:, 0], de[:, 0], va[:, 0]), (kp[:, 1], de[:, 1], va[:, 1])

    def ms_run(views, n_chunks, group, u_boot, u_chunks, K=scene.K):
        S = len(views)
        tr = MultiStreamTracker(cfg, K, S, device=dev)
        f0, f1 = boot_feats(views, group)
        tr.bootstrap(f0, f1, [_gt_scale(scene, o) for _, _, o in views],
                     u=u_boot)
        fn = fused.build_multistream_chunk_fn(cfg, sp, lg, K, CHUNK, S,
                                              extract_group=group)
        outs, recs = [], []
        for c in range(n_chunks):
            a = 2 + c * CHUNK
            imgs = torch.stack([fr[i0 + a:i0 + a + CHUNK]
                                for fr, i0, _ in views])
            st, o_c, r_c = fn(tr.state, imgs, a, u_chunks[c])
            tr.state = st
            nk = st.map.num_kf
            first = torch.clamp_min(nk - win_kf, 0)
            tr.ba(first, nk - first)
            outs += o_c
            recs += r_c
        tr.block()
        return tr, outs, recs

    def single_run(view, K, u_boot, u_chunks, n_chunks):
        """One stream through the unbatched functions."""
        fr, i0, o = view
        K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        st = frontend.init_track_state(cfg, device=dev)
        f0, f1 = boot_feats([view], 1)
        st, _ = frontend.bootstrap_step(
            cfg, K, st,
            frontend.FrameFeatures(*(x[0] for x in f0), torch.zeros(
                (), dtype=torch.int32, device=dev)),
            frontend.FrameFeatures(*(x[0] for x in f1), torch.ones(
                (), dtype=torch.int32, device=dev)),
            torch.tensor(_gt_scale(scene, o), device=dev), u=u_boot)
        fn = fused.build_chunk_fn(cfg, sp, lg, K, CHUNK)
        outs = []
        for c in range(n_chunks):
            a = 2 + c * CHUNK
            st, o_c, _ = fn(st, fr[i0 + a:i0 + a + CHUNK], a, u_chunks[c])
            nk = st.map.num_kf
            first = torch.clamp_min(nk - win_kf, 0)
            m = ba_mod.ba_step(cfg, K, st.map, first, nk - first)
            idx = torch.clamp(m.num_kf - 1, 0, m.capacity_kf - 1)
            st = st._replace(map=m, R_cur=_at(m.kf_R, idx),
                             t_cur=_at(m.kf_t, idx))
            outs += o_c
        return st, outs

    def against_singles(tr, outs, views, Ks, u_boot, u_chunks, n_chunks,
                        what):
        """Each stream of a multi-stream run against its own single-stream
        run. Bound: the whole-run bounds between the JAX package and the
        port (tests/test_torch_slice.py), 1e-3 on rotation entries and
        5e-2 m: phase 3's repeated runs are bit-identical, but a batched
        product sums in another order than an unbatched one, and a
        correspondence that lands on the other side of a threshold moves a
        pose by centimetres."""
        n_kf = 2 + n_chunks * CHUNK
        st = tr.state
        ok = torch.stack([o.frame_ok for o in outs]).cpu().numpy()
        kR, kt = st.map.kf_R.cpu().numpy(), st.map.kf_t.cpu().numpy()
        streams = []
        for s, view in enumerate(views):
            o = view[2]
            st1, outs1 = single_run(view, Ks[s], u_boot[s],
                                    [u[s] for u in u_chunks], n_chunks)
            R1 = st1.map.kf_R[:n_kf].cpu().numpy()
            t1 = st1.map.kf_t[:n_kf].cpu().numpy()
            gap = (float(np.abs(kR[s, :n_kf] - R1).max()),
                   float(np.abs(kt[s, :n_kf] - t1).max()))
            ate = _stream_ate(scene, kR[s], kt[s], n_kf, o)
            ate1 = _stream_ate(scene, R1, t1, n_kf, o)
            d_inl = max(abs(int(a.num_inliers[s]) - int(b.num_inliers))
                        for a, b in zip(outs, outs1))
            d_map = max(abs(int(a.num_map_matches[s])
                            - int(b.num_map_matches))
                        for a, b in zip(outs, outs1))
            mm = float(np.mean([int(a.num_matches[s]) for a in outs]))
            print(f"  {what} stream {s} (offset {o}): {int(ok[:, s].sum())}/"
                  f"{n_chunks * CHUNK} frames, mean matches {mm:.1f}, ATE "
                  f"{ate:.4f} m (single-stream run {ate1:.4f} m), keyframe "
                  f"poses vs the single-stream run {gap[0]:.3g} (R) "
                  f"{gap[1]:.3g} m (t), count differences inliers {d_inl} "
                  f"map matches {d_map}", flush=True)
            check(ate <= 1.0, f"{what} stream {s}: ATE {ate} m > 1 m")
            check(int(st1.map.num_kf) == n_kf, f"{what} stream {s}: the "
                  f"single-stream run kept {int(st1.map.num_kf)} keyframes")
            check(gap[0] <= 1e-3 and gap[1] <= 5e-2, f"{what} stream {s}: "
                  f"keyframe poses {gap} from its single-stream run")
            streams.append(dict(offset=o, ate_m=ate, single_ate_m=ate1,
                                pose_gap_R=gap[0], pose_gap_t_m=gap[1],
                                mean_matches=mm, inlier_count_diff=d_inl,
                                map_match_count_diff=d_map))
        return streams

    S = len(MS_OFFSETS)
    n_kf = 2 + MS_CHUNKS * CHUNK
    views = shared(MS_OFFSETS)
    u_boot, u_chunks = _stream_draws(torch, dev, S, MS_CHUNKS, hyp, 1000)
    per_chunk = {k: v - expected_launches(0)[k]
                 for k, v in expected_launches(1).items()}
    # warm-up (first calls at the stream-batched shapes), then the counted
    # run: launch counters set to 0 just before it and read just after
    ms_run(views, 1, 1, u_boot, u_chunks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    tr, outs, recs = ms_run(views, MS_CHUNKS, 1, u_boot, u_chunks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"attention": MS_CHUNKS * per_chunk["attention"],
            "assignment": MS_CHUNKS * per_chunk["assignment"],
            "nms": S + MS_CHUNKS * S}
    st = tr.state
    ok = torch.stack([o.frame_ok for o in outs]).cpu().numpy()    # (T, S)
    n_rec = int(np.asarray(recs).sum())
    num_kf = st.map.num_kf.cpu().numpy()
    print(f"  {S} streams at offsets {list(MS_OFFSETS)}: bootstrap + "
          f"{MS_CHUNKS} chunks of {CHUNK} + {MS_CHUNKS} BA passes in "
          f"{wall:.2f} s ({S * MS_CHUNKS * CHUNK / wall:.2f} tracked frames/s "
          f"aggregate, bootstrap included), keyframes {num_kf.tolist()}, "
          f"recovery-branch frames {n_rec}, peak allocated "
          f"{peak / 2**20:.0f} MiB, launches {launches} (expected {want})",
          flush=True)
    check(launches == want, f"multi-stream: launch counts {launches} != "
          f"{want} (attention and assignment per chunk as for one stream)")
    check(ok.all() and (num_kf == n_kf).all() and n_rec == 0,
          f"multi-stream: frames kept {ok.sum(0).tolist()} of "
          f"{MS_CHUNKS * CHUNK} per stream, recovery-branch frames {n_rec}")
    check(all(bool(torch.isfinite(x).all()) for x in (*st.map, *st[1:])
              if torch.is_tensor(x) and x.is_floating_point()),
          "multi-stream: non-finite state")
    streams = against_singles(tr, outs, views, [scene.K] * S, u_boot,
                              u_chunks, MS_CHUNKS, "shared K")

    # this slice's path: each stream its own camera, K (S, 3, 3), with f
    # and the principal point moved by 1-3 % as KITTI's calibrations
    # differ; each stream's frames rendered through its own camera
    t0 = time.perf_counter()
    Ks = [_camera(scene.K, s) for s in range(S)]
    k_views = []
    for s, o in enumerate(MS_OFFSETS):
        sc = scene._replace(K=Ks[s])
        imgs = np.stack([synthetic.render_frame(
            sc, o + i, max_keypoints=cfg.frontend.max_keypoints)
            for i in range(2 + CHUNK)]).astype(np.float32)
        k_views.append((torch.from_numpy(imgs).to(dev), 0, o))
    render_s = time.perf_counter() - t0
    uk_boot, uk_chunks = _stream_draws(torch, dev, S, 1, hyp, 3000)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    trk, outs_k, recs_k = ms_run(k_views, 1, 1, uk_boot, uk_chunks,
                                 K=np.stack(Ks).astype(np.float32))
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches_k = dict(_build.LAUNCHES)
    want_k = {"attention": per_chunk["attention"],
              "assignment": per_chunk["assignment"], "nms": 2 * S}
    ok_k = torch.stack([o.frame_ok for o in outs_k]).cpu().numpy()
    n_rec_k = int(np.asarray(recs_k).sum())
    kf_k = trk.state.map.num_kf.cpu().numpy()
    print(f"  {S} streams with distinct K (fx "
          f"{[round(float(K[0, 0]), 2) for K in Ks]}, cx "
          f"{[round(float(K[0, 2]), 2) for K in Ks]}; {S * (2 + CHUNK)} "
          f"frames rendered in {render_s:.1f} s): bootstrap + 1 chunk + BA in "
          f"{wall_k:.2f} s ({S * CHUNK / wall_k:.2f} tracked frames/s "
          f"aggregate, bootstrap included), keyframes {kf_k.tolist()}, "
          f"recovery-branch frames {n_rec_k}, launches {launches_k} "
          f"(expected {want_k})", flush=True)
    check(launches_k == want_k, f"distinct K: launch counts {launches_k} != "
          f"{want_k} (attention and assignment per chunk as for one stream)")
    check(ok_k.all() and (kf_k == 2 + CHUNK).all() and n_rec_k == 0,
          f"distinct K: frames kept {ok_k.sum(0).tolist()}, recovery-branch "
          f"frames {n_rec_k}")
    streams_k = against_singles(trk, outs_k, k_views, Ks, uk_boot, uk_chunks,
                                1, "distinct K")

    # sixteen streams, one chunk (BASELINE configs[4])
    offs = tuple(range(MS_BIG))
    ub, uc = _stream_draws(torch, dev, MS_BIG, 1, hyp, 2000)
    ms_run(shared(offs), 1, MS_BIG_GROUP, ub, uc)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    tr16, outs16, recs16 = ms_run(shared(offs), 1, MS_BIG_GROUP, ub, uc)
    torch.cuda.synchronize()
    wall16 = time.perf_counter() - t0
    launches16 = dict(_build.LAUNCHES)
    peak16 = torch.cuda.max_memory_allocated()
    want16 = {"attention": per_chunk["attention"],
              "assignment": per_chunk["assignment"],
              "nms": 2 * MS_BIG // MS_BIG_GROUP}
    ok16 = torch.stack([o.frame_ok for o in outs16]).cpu().numpy()
    st16 = tr16.state
    print(f"  {MS_BIG} streams, extraction in groups of {MS_BIG_GROUP}: "
          f"bootstrap + 1 chunk + BA in {wall16:.2f} s "
          f"({MS_BIG * CHUNK / wall16:.2f} tracked frames/s aggregate, "
          f"bootstrap included), frames kept {int(ok16.sum())}/"
          f"{MS_BIG * CHUNK}, torch.cuda.max_memory_allocated "
          f"{peak16 / 2**20:.0f} MiB, launches {launches16} (expected "
          f"{want16})", flush=True)
    check(launches16 == want16, f"16 streams: launch counts {launches16} != "
          f"{want16}")
    check(ok16.all(), f"16 streams: frames kept per stream "
          f"{ok16.sum(0).tolist()}")
    check(all(bool(torch.isfinite(x).all()) for x in (*st16.map, *st16[1:])
              if torch.is_tensor(x) and x.is_floating_point()),
          "16 streams: non-finite state")
    details["multistream"] = dict(
        config="flagship_config(), BA after every chunk (window 8 + "
               "overlap), centroid subpix, phase 3's frames at per-stream "
               "offsets, per-stream RANSAC generators",
        offsets=list(MS_OFFSETS), chunks=MS_CHUNKS, wall_s=wall,
        launches=launches, expected_launches=want,
        peak_allocated_bytes=peak, streams=streams,
        distinct_K=dict(K=[np.asarray(K).tolist() for K in Ks], chunks=1,
                        wall_s=wall_k, render_s=render_s,
                        launches=launches_k, expected_launches=want_k,
                        streams=streams_k),
        big=dict(streams=MS_BIG, extract_group=MS_BIG_GROUP, wall_s=wall16,
                 launches=launches16, expected_launches=want16,
                 peak_allocated_bytes=peak16,
                 frames_kept=int(ok16.sum()),
                 recovery_frames=int(np.asarray(recs16).sum())))
    return launches_k


# ---------------------------------------------------------------------------
# Phase 12: the batched entry points and the covisibility graph

def _covis_edges_plain(table, threshold):
    """The covisibility graph's edge count by the plain rule: keyframes
    enter in order; an edge joins a keyframe to each earlier one that
    observed at least `threshold` of its points (ids < 0 ignored)."""
    observers, edges = {}, 0
    for kf, ids in enumerate(table):
        shared = {}
        for p in ids:
            if p < 0:
                continue
            for other in observers.get(p, []):
                if other != kf:
                    shared[other] = shared.get(other, 0) + 1
            observers.setdefault(p, []).append(kf)
        edges += sum(1 for w in shared.values() if w >= threshold)
    return edges


def run_entry_points(torch, dev, details, cfg, sp, lg, stack, slice_map):
    """SuperPointExtractor and LightGlueMatcher on the card with the
    committed flagship weights, on the first two rendered frames: launch
    counts, and the features and matches equal bit for bit to the chunk's
    own extraction (with a one-pixel refinement window, which leaves the
    integer detections as they are) and to the prologue's matcher; then
    CovisGraph over phase 3's final keyframe / point table: its edge count
    against the plain rule, and one query."""
    import dataclasses

    import numpy as np

    from gl_slam_tpu_torch.models.lightglue import LightGlueMatcher
    from gl_slam_tpu_torch.models.superpoint import SuperPointExtractor
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.runtime import native_lib
    from gl_slam_tpu_torch.slam import fused

    fe = cfg.frontend
    H, W, N = fe.image_height, fe.image_width, fe.max_keypoints
    ex = SuperPointExtractor(H, W, max_keypoints=N,
                             score_threshold=fe.score_threshold,
                             nms_radius=fe.nms_radius, net=sp)
    mt = LightGlueMatcher(H, W, threshold=0.0, net=lg)
    imgs = torch.from_numpy(stack[:2]).to(dev)
    ex(imgs)                                    # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    kp, sc, de, va = ex(imgs)
    m = mt(kp[:1], de[:1], va[:1], kp[1:], de[1:], va[1:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    want = {"attention": 18, "assignment": ASSIGN_KERNELS_PER_CALL,
            "nms": 1}
    cfg1 = dataclasses.replace(cfg, frontend=dataclasses.replace(
        fe, subpix_patch=1))
    with torch.no_grad():
        k2, d2, v2 = fused.build_extract_fn(cfg1, sp)(imgs)
        m2 = fused.build_matcher(cfg, lg)(k2[:1], d2[:1], v2[:1], k2[1:],
                                          d2[1:], v2[1:])
    same_f = all(torch.equal(a, b) for a, b in ((kp, k2), (de, d2),
                                                (va, v2)))
    same_m = torch.equal(m.matches0, m2.matches0) and torch.equal(
        m.mscores0, m2.mscores0)
    n_match = int((m.matches0 >= 0).sum())
    print(f"  SuperPointExtractor 2x{H}x{W} + LightGlueMatcher 1 pair in "
          f"{1e3 * wall:.1f} ms: {va.sum(1).tolist()} keypoints, {n_match} "
          f"mutual matches; equal to the chunk's extraction {same_f} and "
          f"matcher {same_m}; launches {launches} (expected {want})",
          flush=True)
    check(launches == want, f"entry points: launch counts {launches} != "
          f"{want}")
    check(same_f, "SuperPointExtractor differs from build_extract_fn")
    check(same_m, "LightGlueMatcher differs from the chunk's matcher")
    check(n_match > 300, f"LightGlueMatcher: {n_match} matches")

    nk = int(slice_map.num_kf)
    table = slice_map.kf_kp2mp[:nk].cpu().numpy().astype(np.int64)
    thr = cfg.map.covis_edge_threshold
    t0 = time.perf_counter()
    g = native_lib.CovisGraph(edge_threshold=thr)   # g++ at first use
    build_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for kf, ids in enumerate(table):
        g.add_keyframe(kf, ids)
    seeds = table[-1][table[-1] >= 0]
    found = g.query(seeds)
    pts = g.points_of(np.asarray([nk - 1]), np.zeros(0, np.int64),
                      max_out=N)
    graph_ms = 1e3 * (time.perf_counter() - t0)
    edges, plain = g.num_edges, _covis_edges_plain(table, thr)
    print(f"  CovisGraph (library ready in {build_ms:.1f} ms) over phase "
          f"3's {nk} keyframes (edge threshold {thr}), built and queried in "
          f"{graph_ms:.1f} ms: {edges} edges (plain rule "
          f"{plain}); query from the last keyframe's {len(seeds)} points -> "
          f"keyframes {found.tolist()}; its points {len(pts)}", flush=True)
    check(edges == plain and edges > 0, f"CovisGraph: {edges} edges, the "
          f"plain rule {plain}")
    check(nk - 1 in found.tolist() and len(set(found.tolist()))
          == len(found) and all(0 <= k < nk for k in found.tolist()),
          f"CovisGraph query: {found.tolist()}")
    check(sorted(pts.tolist()) == sorted(set(seeds.tolist())),
          "CovisGraph points_of the last keyframe")
    details["entry_points"] = dict(
        launches=launches, expected_launches=want, wall_ms=1e3 * wall,
        keypoints=va.sum(1).tolist(), matches=n_match,
        covis=dict(keyframes=nk, edge_threshold=thr, edges=edges,
                   query=found.tolist(), library_ms=build_ms,
                   graph_ms=graph_ms))


# ---------------------------------------------------------------------------
# Phase 13: point-table turnover at flagship width

def run_turnover(torch, dev, details):
    """The long run's path at a cut depth: `run_learned_e2e` over the first
    TURNOVER_FRAMES frames of its scene with the table pinned small (see
    TURNOVER_*), counted and unprofiled. Every recycling pass (one a BA
    pass) is recorded beside the same pass without the eviction under
    pressure (`stale_age=0`) on the same table: the difference is what
    that eviction freed. Returns the run's launches."""
    import dataclasses

    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import longrun_learned_torch as longrun
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.slam import chunk_driver
    from gl_slam_tpu_torch.train import e2e, evals

    args = longrun.parse_args([
        "--preset", "flagship", "--frames", str(TURNOVER_FRAMES),
        "--scene-frames", str(LONGRUN_SCENE_FRAMES), "--max-points",
        str(TURNOVER_MAX_POINTS), "--weights",
        os.path.join(ROOT, "checkpoints")])
    args.device = dev
    sp, lg, subpix, scene, cfg, run = longrun.setup(args)
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, max_keyframes=TURNOVER_MAX_KEYFRAMES,
        recycle_min_age=TURNOVER_AGE, recycle_stale_age=TURNOVER_AGE))
    check(cfg.runtime.loop_closing and subpix is not None,
          "turnover run: loop closing off or no pair head")
    chunk, ba_every = run["chunk"], run["ba_every"]
    t0 = time.perf_counter()
    stack = e2e.render_stack(scene, TURNOVER_FRAMES,
                             cfg.frontend.max_keypoints)
    render_s = time.perf_counter() - t0
    n_chunks = (TURNOVER_FRAMES - 2) // chunk
    checks = evals.loop_checks_implied(cfg, TURNOVER_FRAMES, chunk)
    want = expected_launches(n_chunks)
    want["attention"] += ATTN_PER_DETECTION * len(checks)
    want["assignment"] += ASSIGN_KERNELS_PER_CALL * len(checks)

    passes = []
    recycle = chunk_driver.recycle_free_slots

    def recorded(m, min_age, budget, stale_age=0):
        out = recycle(m, min_age, budget, stale_age=stale_age)
        culled = recycle(m, min_age, budget, stale_age=0)
        passes.append((out.num_kf, out.num_pts, out.free_count,
                       culled.free_count))
        return out

    diag = {}
    chunk_driver.recycle_free_slots = recorded
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = e2e.run_learned_e2e(sp, lg, scene, cfg, TURNOVER_FRAMES,
                                  chunk=chunk, ba_every=ba_every,
                                  device=dev, stack=stack, subpix=subpix,
                                  diag_out=diag)
        torch.cuda.synchronize()
    finally:
        chunk_driver.recycle_free_slots = recycle
    launches = dict(_build.LAUNCHES)
    wall = time.perf_counter() - t0
    cap = cfg.map.max_points
    rows = []
    for kf, num_pts, stack_n, culled_n in passes:
        fresh = cap - int(num_pts)
        rows.append(dict(keyframes=int(kf), free_slots=fresh + int(stack_n),
                         fresh=fresh, stack=int(stack_n),
                         evicted_under_pressure=int(stack_n) - int(culled_n)))
    o = diag["outputs"]
    drift = 100.0 * res.ate_m / max(res.num_frames, 1)
    print(f"  frames {res.num_frames} keyframes {res.num_keyframes} "
          f"rejected {res.num_rejected} mean matches {res.mean_matches:.1f} "
          f"ATE {res.ate_m:.4f} m ({drift:.3f} % of the trajectory) BA runs "
          f"{res.num_ba_runs} recoveries {diag['num_recoveries']} loop checks "
          f"at {[c['frames'] for c in diag['loop_checks']]} (implied "
          f"{checks}) closures {res.loop_closures}; new points "
          f"{res.total_new_points} into a table of {cap} "
          f"({res.total_new_points / cap:.2f}x), {cfg.map.max_keyframes} "
          f"keyframe slots, recycling ages {TURNOVER_AGE}; tracked fps "
          f"{res.fps:.2f}, peak allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; launches "
          f"{launches} (expected {want}); render {render_s:.1f} s, run "
          f"{wall:.1f} s", flush=True)
    for i, r in enumerate(rows):
        print(f"  BA pass {i + 1} at {r['keyframes']} keyframes: free slots "
              f"{r['free_slots']} (fresh {r['fresh']} + stack {r['stack']}), "
              f"{r['evicted_under_pressure']} of the stack freed by the "
              f"eviction under pressure this pass", flush=True)
    check(np.isfinite(diag["R"]).all() and np.isfinite(diag["t"]).all()
          and np.isfinite(o.R).all() and np.isfinite(o.t).all(),
          "turnover run: non-finite pose")
    check(res.num_frames == TURNOVER_FRAMES - (TURNOVER_FRAMES - 2) % chunk,
          f"turnover run: {res.num_frames} frames")
    check(res.num_keyframes == res.num_frames and res.num_rejected == 0,
          f"turnover run: {res.num_keyframes} keyframes of "
          f"{res.num_frames} frames")
    # tests/test_longrun.py's bounds
    check(drift <= 8.0, f"turnover run: drift {drift:.3f} % > 8 %")
    check(cap <= 0.5 * res.total_new_points
          and res.total_new_points > 1.5 * cap,
          f"turnover run: {res.total_new_points} new points into a table "
          f"of {cap}")
    check(diag["num_recoveries"] == 0,
          f"turnover run: {diag['num_recoveries']} recoveries")
    check(res.num_ba_runs == n_chunks // max(ba_every // chunk, 1)
          and len(rows) == res.num_ba_runs,
          f"turnover run: {res.num_ba_runs} BA runs, {len(rows)} recycling "
          f"passes")
    check(sum(r["evicted_under_pressure"] for r in rows) > 0,
          "turnover run: the eviction under pressure freed nothing")
    check([c["frames"] for c in diag["loop_checks"]] == checks,
          f"turnover run: loop checks {diag['loop_checks']} != {checks}")
    check(launches == want,
          f"turnover run: launch counts {launches} != {want}")
    details["turnover"] = dict(
        config=f"scripts/longrun_learned_torch.py --preset flagship --frames "
               f"{TURNOVER_FRAMES} --scene-frames {LONGRUN_SCENE_FRAMES} "
               f"--max-points {cap}, max_keyframes "
               f"{cfg.map.max_keyframes}, recycle_min_age = "
               f"recycle_stale_age = {TURNOVER_AGE}, warm-up off",
        frames=res.num_frames, keyframes=res.num_keyframes,
        ate_m=res.ate_m, drift_pct=drift, mean_matches=res.mean_matches,
        ba_runs=res.num_ba_runs, recoveries=diag["num_recoveries"],
        total_new_points=res.total_new_points, max_points_capacity=cap,
        loop_checks=[c["frames"] for c in diag["loop_checks"]],
        loop_closures=res.loop_closures, fps=res.fps,
        peak_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        recycling_passes=rows, launches=launches, expected_launches=want,
        render_s=render_s, run_wall_s=wall,
        num_new_points=o.num_new_points.tolist())
    return launches


# ---------------------------------------------------------------------------
# Phase 11: front-end training at flagship width

def _grads(torch, module):
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()
            if p.grad is not None}


def _lg_grads(torch, lg, batch, H, W, attention_fn=None):
    """lightglue_loss's gradient of every matcher parameter, with the
    matcher's attention through `attention_fn` (default: the dispatch,
    i.e. the kernel under autograd)."""
    from gl_slam_tpu_torch.ops import attention as A
    from gl_slam_tpu_torch.train import frontend_train as ft
    real = A.attention
    if attention_fn is not None:
        A.attention = attention_fn
    try:
        lg.zero_grad(set_to_none=True)
        loss = ft.lightglue_loss(lg, batch, H, W)
        loss.backward()
    finally:
        A.attention = real
    return float(loss.detach()), _grads(torch, lg)


def check_matcher_gradient(torch, dev, lg, batch, H, W, out):
    """One lightglue_loss backward on a flagship training batch through the
    kernel (KernelAttention) and through attention_plain, parameter by
    parameter. The tolerance follows attention_tolerance: the kernel's
    forward may differ from the plain one by up to that elementwise bound
    at every attention call, so the plain network is run twice more with
    its attention outputs moved by the full bound (once with random
    signs, once all positive); per parameter the kernel's gradient must
    lie within twice the larger of those two moves of the plain one.
    Every q/k/v weight's gradient must be non-zero."""
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.ops import attention as A
    gen = torch.Generator(device=dev).manual_seed(11)

    def moved(random_signs):
        def fn(q, k, v, mask_k, scale):
            with torch.no_grad():
                tol = A.attention_tolerance(q, k, v, mask_k, scale)
                if random_signs:
                    tol = tol * torch.sign(torch.randn(
                        tol.shape, generator=gen, device=dev))
            return A.attention_plain(q, k, v, mask_k, scale) + tol
        return fn

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    loss_k, g_kernel = _lg_grads(torch, lg, batch, H, W)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    loss_p, g_plain = _lg_grads(torch, lg, batch, H, W, A.attention_plain)
    _, g_rand = _lg_grads(torch, lg, batch, H, W, moved(True))
    _, g_pos = _lg_grads(torch, lg, batch, H, W, moved(False))
    check(launches["attention"] == 2 * LG_LAYERS,
          f"gradient check: {launches['attention']} attention launches for "
          f"one forward and backward, not {2 * LG_LAYERS}")
    check(set(g_kernel) == set(g_plain) == {n for n, _ in
                                            lg.named_parameters()},
          "gradient check: a parameter has no gradient")
    worst, worst_name, rows = -1.0, None, {}
    for n, g in g_kernel.items():
        err = float((g - g_plain[n]).norm())
        tol = 2 * max(float((g_rand[n] - g_plain[n]).norm()),
                      float((g_pos[n] - g_plain[n]).norm())) \
            + 1e-6 * float(g_plain[n].norm())
        rows[n] = dict(err=err, tol=tol, norm=float(g_plain[n].norm()))
        if err / tol > worst:
            worst, worst_name = err / tol, n
    qkv = [n for n in g_kernel if n.endswith("weight")
           and n.rsplit(".", 2)[-2] in ("q", "k", "v")]
    check(len(qkv) == LG_LAYERS * 2 * 3, f"q/k/v weights: {len(qkv)}")
    zero = [n for n in qkv if not bool(g_kernel[n].abs().max() > 0)]
    check(not zero, f"gradient check: zero gradient for {zero}")
    r = rows[worst_name]
    print(f"  gradient check (batch of {TRAIN_PAIRS} pairs, N {N_KPTS}): "
          f"loss kernel {loss_k:.6f} plain {loss_p:.6f}; per parameter "
          f"|g_kernel - g_plain| <= 2 x the larger move of the plain "
          f"gradient under attention outputs moved by the full "
          f"attention_tolerance (random / positive signs); worst "
          f"{worst:.3g} of it at {worst_name} (err {r['err']:.3g}, tol "
          f"{r['tol']:.3g}, |g| {r['norm']:.3g}); {len(qkv)} q/k/v weights "
          f"non-zero; {launches['attention']} attention launches "
          f"(forward only); peak allocated {peak / 2**20:.0f} MiB",
          flush=True)
    check(worst <= 1.0, f"gradient check: {worst_name} differs by {worst:.3g}"
          f" x its tolerance")
    out["gradient_check"] = dict(
        loss_kernel=loss_k, loss_plain=loss_p, worst_ratio=worst,
        worst_param=worst_name, per_param=rows, launches=launches,
        peak_allocated_bytes=peak, qkv_weights=len(qkv))


def time_attention_backward(torch, dev, out):
    """The recompute backward at the matcher's training shape (2 pairs x 2
    stacked sets x 2 heads x 2048 x 2048, dh 128): plain PyTorch library
    calls (the plain version's VJP), timed beside the forward kernel."""
    from gl_slam_tpu_torch.ops import attention as A
    gen = torch.Generator(device=dev).manual_seed(12)
    shape = (TRAIN_PAIRS, 2, HEADS, N_KPTS, HEAD_DIM)
    leaves = [torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_() for _ in range(3)]
    mask = torch.rand(TRAIN_PAIRS, 2, N_KPTS, generator=gen,
                      device=dev) < 0.8
    cot = torch.randn(shape, generator=gen, device=dev)
    scale = HEAD_DIM ** -0.5
    res = A.attention(*leaves, mask, scale)
    bwd = time_ms(lambda: torch.autograd.grad(res, leaves, cot,
                                              retain_graph=True), reps=10)
    fwd = time_ms(lambda: A.attention(*leaves, mask, scale), reps=10)
    # the backward's least work: recompute q k^T, then dP = g v^T, dq, dk
    # and dv, five products of 2 Nq Nk dh operations per (set, head)
    flops = 5 * 2.0 * math.prod(shape[:3]) * N_KPTS * N_KPTS * HEAD_DIM
    nbytes = 2 * 3 * leaves[0].numel() * 2 + 4 * cot.numel() \
        + mask.numel()
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"  attention under autograd at {'x'.join(map(str, shape))}: "
          f"forward (kernel) {fwd:.4f} ms, backward (the plain version's "
          f"VJP: library calls, no kernel of ours) {bwd:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    out["attention_backward"] = dict(shape=list(shape), forward_ms=fwd,
                                     backward_ms=bwd, bound_ms=bound_ms,
                                     bound_by=bound_by)


def run_training(torch, dev, details, sp_flagship):
    """This slice's path: the four trainers of gl_slam_tpu_torch/train/
    frontend_train.py at the flagship preset's width on the card (3 steps
    each, chained as scripts/train_frontend_torch.py chains them), the
    matcher's gradient through the kernel against the plain version,
    30-step descent on fixed batches, and the save_params round trip. The
    gradient check and the matcher's descent take their descriptors from
    the committed flagship SuperPoint `sp_flagship`, as train_lightglue
    takes them from a trained one: on the descriptors of a SuperPoint 3
    steps from its initialisation the matcher has little to learn in 30
    steps."""
    import shutil

    import numpy as np

    from gl_slam_tpu_torch import checkpoint as ckpt
    from gl_slam_tpu_torch.config import (FLAGSHIP_DESC_DIM, FLAGSHIP_LG,
                                          FLAGSHIP_SP_CHANNELS)
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.models import init_like_flax
    from gl_slam_tpu_torch.models.lightglue import LightGlueNet
    from gl_slam_tpu_torch.models.subpix import PairSubpixHead, SubpixHead
    from gl_slam_tpu_torch.models.superpoint import SuperPointNet
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.train import frontend_train as ft

    H, W, N, D = TRAIN_H, TRAIN_W, N_KPTS, FLAGSHIP_DESC_DIM
    check(FLAGSHIP_LG == dict(dim=256, heads=HEADS, layers=LG_LAYERS),
          f"flagship matcher {FLAGSHIP_LG}")
    t0 = time.perf_counter()
    scene = synthetic.make_scene(num_landmarks=20000,
                                 num_frames=TRAIN_FRAMES, height=H, width=W,
                                 desc_dim=D, seed=7)
    sp = SuperPointNet(descriptor_dim=D, channels=FLAGSHIP_SP_CHANNELS)
    ks = SubpixHead(D, patch=7, offset_range=1.5)
    kp = PairSubpixHead(D, patch=7, offset_range=1.5)
    lg = LightGlueNet(input_dim=D, **FLAGSHIP_LG)
    out = dict(config=f"flagship preset {H}x{W}, N {N}, D {D}, SP "
                      f"{FLAGSHIP_SP_CHANNELS}, LightGlue {FLAGSHIP_LG}, "
                      f"make_scene(num_landmarks=20000, num_frames="
                      f"{TRAIN_FRAMES}, seed=7)", trainers={})
    steps_lg = TRAIN_STEPS
    want = {
        "superpoint": {"attention": 0, "assignment": 0, "nms": 0},
        # one detection call per 8 staged frames
        "subpix": {"attention": 0, "assignment": 0,
                   "nms": -(-TRAIN_FRAMES // 8)},
        "pair_subpix": {"attention": 0, "assignment": 0,
                        "nms": -(-TRAIN_FRAMES // 8)},
        # forward launches only: 9 layers x (self + cross) per step
        "lightglue": {"attention": steps_lg * LG_LAYERS * 2,
                      "assignment": 0, "nms": 0},
    }
    runs = (("superpoint", ft.train_superpoint, (sp,), dict(batch_size=4)),
            ("subpix", ft.train_subpix, (ks, sp), {}),
            ("pair_subpix", ft.train_pair_subpix, (kp, sp), {}),
            ("lightglue", ft.train_lightglue, (lg, sp),
             dict(batch_size=TRAIN_PAIRS, desc_age_max=6, jitter_px=1.0)))
    launches_all = {"attention": 0, "assignment": 0, "nms": 0}
    for name, fn, mods, kw in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        stats = {}
        t1 = time.perf_counter()
        fn(*mods, scene, TRAIN_FRAMES, N, steps=TRAIN_STEPS, device=dev,
           stats=stats, **kw)
        stats["wall_s"] = time.perf_counter() - t1
        launches = dict(_build.LAUNCHES)
        stats["launches"] = launches
        stats["expected_launches"] = want[name]
        stats["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        for k_, v_ in launches.items():
            launches_all[k_] += v_
        out["trainers"][name] = stats
        print(f"  {name}: {TRAIN_STEPS} steps, {stats['step_ms']:.2f} ms a "
              f"step after the first (first step {stats['first_step_s']:.3f}"
              f" s, staging {stats['stage_s']:.2f} s); loss "
              f"{stats['first_loss']:.4f} -> {stats['last_loss']:.4f}; "
              f"launches {launches} (expected {want[name]}); peak "
              f"allocated {stats['peak_allocated_bytes'] / 2**20:.0f} MiB",
              flush=True)
        check(launches == want[name], f"{name}: launches {launches} != "
              f"{want[name]}")
        check(np.isfinite([stats["first_loss"], stats["last_loss"]]).all(),
              f"{name}: non-finite loss")
    out["launches"] = launches_all
    sp.eval()

    # the matcher's gradient through the kernel against the plain version
    data = ft.stage_matcher_data(sp_flagship, [scene], TRAIN_FRAMES, N,
                                 dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    idx = lambda *a: torch.tensor(a, device=dev)
    lg_batch = ft.lightglue_batch(data, idx(0, 3), idx(1, 5), idx(0, 1),
                                  1.0, True, gen)
    check_matcher_gradient(torch, dev, lg, lg_batch, H, W, out)
    time_attention_backward(torch, dev, out)

    # descent on fixed batches: the SuperPoint bound of tests/
    # test_learned_e2e.py::test_training_steps_reduce_losses (Adam 2e-3),
    # and the matcher with the trainer's optimiser
    ds = ft.stage_packs([scene], TRAIN_FRAMES, N, dev)
    sp_fresh = init_like_flax(SuperPointNet(
        descriptor_dim=D, channels=FLAGSHIP_SP_CHANNELS),
        torch.Generator().manual_seed(0)).to(dev)
    sp_batch = ft.superpoint_batch(ds, idx(0, 4), idx(2, 5), gen)
    opt = torch.optim.Adam(sp_fresh.parameters(), lr=2e-3)
    sp_losses = []
    for _ in range(DESCENT_STEPS):
        loss, _ = ft.superpoint_loss(sp_fresh, sp_batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sp_losses.append(loss.detach())
    lg_fresh = init_like_flax(LightGlueNet(input_dim=D, **FLAGSHIP_LG),
                              torch.Generator().manual_seed(1)).to(dev)
    lopt = ft.ClipAdam(lg_fresh.parameters(), 8e-4)
    lg_losses = []
    for _ in range(DESCENT_STEPS):
        loss = ft.lightglue_loss(lg_fresh, lg_batch, H, W)
        lopt.step(loss)
        lg_losses.append(loss.detach())
    sp_losses = [float(x) for x in sp_losses]
    lg_losses = [float(x) for x in lg_losses]
    print(f"  descent on a fixed batch, {DESCENT_STEPS} steps: SuperPoint "
          f"{sp_losses[0]:.4f} -> {sp_losses[-1]:.4f} (bound < 0.7 x the "
          f"first), LightGlue {lg_losses[0]:.4f} -> {lg_losses[-1]:.4f} "
          f"(bound < the first)", flush=True)
    check(np.isfinite(sp_losses + lg_losses).all(), "descent: non-finite "
          "loss")
    check(sp_losses[-1] < 0.7 * sp_losses[0], f"SuperPoint descent "
          f"{sp_losses[0]} -> {sp_losses[-1]}")
    check(lg_losses[-1] < lg_losses[0], f"LightGlue descent "
          f"{lg_losses[0]} -> {lg_losses[-1]}")
    out["descent"] = dict(superpoint=sp_losses, lightglue=lg_losses)

    # save_params, then the port's loader: a bit-equal forward
    tmp = os.path.join(ROOT, "chiprun_out", "train_roundtrip")
    os.makedirs(tmp, exist_ok=True)
    try:
        img = ds.images[:2, ..., None]
        kd = data.grids[0, :4, :4].reshape(16, D)
        pt = torch.rand(16, 7, 7, generator=gen, device=dev)
        kk = torch.rand(16, 2, generator=gen, device=dev) * 2 - 1
        km = torch.ones(16, dtype=torch.bool, device=dev)
        sc = torch.rand(16, generator=gen, device=dev)
        for tag, module, fresh, conv, args in (
                ("sp", sp, SuperPointNet(descriptor_dim=D,
                                         channels=FLAGSHIP_SP_CHANNELS),
                 ckpt.superpoint_state_dict, (img,)),
                ("ks", ks, SubpixHead(D, patch=7, offset_range=1.5),
                 ckpt.subpix_state_dict, (pt, kd)),
                ("kspair", kp, PairSubpixHead(D, patch=7, offset_range=1.5),
                 ckpt.subpix_state_dict, (pt, pt, kd, kd, sc)),
                ("lg", lg, LightGlueNet(input_dim=D, **FLAGSHIP_LG),
                 ckpt.lightglue_state_dict, (kd, kd, kk, kk, km, km))):
            path = ckpt.params_path(tmp, tag)
            ckpt.save_params(path, module)
            ckpt.load_module(fresh, path, conv)
            fresh.to(dev).eval()
            module.eval()
            with torch.no_grad():
                a, b = module(*args), fresh(*args)
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"round trip {tag}: the forward differs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("  save_params -> load_module: the four networks' forwards equal "
          "bit for bit", flush=True)
    out["wall_s"] = time.perf_counter() - t0
    details["training"] = out
    return launches_all


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from gl_slam_tpu_torch.device import resolve_device
        from gl_slam_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the gl_slam_tpu_torch package is missing next "
              f"to this script ({e})", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    details = {}
    t_start = time.perf_counter()
    try:
        card = card_line()
        print(f"card: {card}", flush=True)
        dev = resolve_device("cuda")          # also switches TF32 off
        details["card"] = card
        details["torch"] = torch.__version__
        t0 = time.perf_counter()
        reports = _build.build_all()
        print(f"phase 1: built {sorted(reports)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name, log in reports.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        details["ptxas"] = reports

        slice_args = setup_slice(dev)
        cfg, sp, _, _, stack = slice_args

        print(f"phase 2: kernels against their plain versions "
              f"[{time.perf_counter() - t_start:.0f} s]", flush=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        attn_rows, asg_rows, nms_rows = [], [], []
        attn_err = check_attention(torch, gen, dev, attn_rows)
        asg_err = check_assignment(torch, gen, dev, asg_rows)
        nms_err = check_nms(torch, gen, dev, nms_rows, cfg, sp, stack)
        details["attention"] = attn_rows
        details["assignment"] = asg_rows
        details["nms"] = nms_rows

        print(f"phase 3: flagship-width chunked tracker with window BA "
              f"[{time.perf_counter() - t_start:.0f} s]", flush=True)
        slice_poses, slice_map = run_slice(torch, dev, details, *slice_args)
        print(f"phase 4: the same tracker with BA off, bootstrap + 1 chunk "
              f"[{time.perf_counter() - t_start:.0f} s]", flush=True)
        run_no_ba(torch, dev, details, *slice_args)
        print(f"phase 5: the tracker with BA and the pair sub-pixel head, "
              f"bootstrap + 2 chunks [{time.perf_counter() - t_start:.0f} s]",
              flush=True)
        run_pair(torch, dev, details, *slice_args)
        print(f"phase 6: the Done scenario, {DONE_FRAMES} frames, pair head, "
              f"BA and loop closing [{time.perf_counter() - t_start:.0f} s]",
              flush=True)
        run_done(torch, dev, details)
        print(f"phase 7: the command line on a KITTI-layout directory, "
              f"flagship preset, single-view head, padded tail chunk "
              f"[{time.perf_counter() - t_start:.0f} s]", flush=True)
        data = run_cli(torch, dev, details)
        print(f"phase 8: the command line's per-frame route on the same "
              f"directory: superpoint --per-frame (flagship), Harris, "
              f"oracle [{time.perf_counter() - t_start:.0f} s]", flush=True)
        run_per_frame(torch, details, data)
        print(f"phase 9: the tracker options on phase 3's frames: batched "
              f"and merged re-observation, PnP, motion gating "
              f"[{time.perf_counter() - t_start:.0f} s]", flush=True)
        run_options(torch, dev, details, *slice_args, slice_poses)
        print(f"phase 10: multi-stream tracking, {len(MS_OFFSETS)} streams "
              f"x {MS_CHUNKS} chunks with BA, then {MS_BIG} streams x 1 chunk "
              f"[{time.perf_counter() - t_start:.0f} s]", flush=True)
        run_multistream(torch, dev, details, *slice_args)
        print(f"phase 11: front-end training at flagship width, "
              f"{TRAIN_STEPS} steps of each trainer, the matcher's gradient "
              f"through the kernel, descent, the save_params round trip "
              f"[{time.perf_counter() - t_start:.0f} s]", flush=True)
        run_training(torch, dev, details, sp)
        print(f"phase 12: SuperPointExtractor and LightGlueMatcher at "
              f"flagship width, CovisGraph over phase 3's map "
              f"[{time.perf_counter() - t_start:.0f} s]", flush=True)
        run_entry_points(torch, dev, details, cfg, sp, slice_args[2], stack,
                         slice_map)
        print(f"phase 13: point-table turnover at flagship width, the long "
              f"run's scene, {TURNOVER_FRAMES} frames into a "
              f"{TURNOVER_MAX_POINTS}-point table "
              f"[{time.perf_counter() - t_start:.0f} s]", flush=True)
        path_launches = run_turnover(torch, dev, details)
        details["wall_s"] = time.perf_counter() - t_start
        print(f"all phases passed [{details['wall_s']:.0f} s]", flush=True)

        kernels = []
        path = "phase 13 (the long run's scene, point-table turnover)"
        for name, rows, err, src, replaces, shape in (
                ("attention", attn_rows, attn_err,
                 "gl_slam_tpu_torch/csrc/attention.cu",
                 "gl_slam_tpu/ops/attention.py:68",
                 f"prologue {CHUNK}x"),
                ("assignment", asg_rows, asg_err,
                 "gl_slam_tpu_torch/csrc/assignment.cu",
                 "gl_slam_tpu/ops/assignment.py:128",
                 f"prologue {CHUNK}x"),
                ("nms", nms_rows, nms_err,
                 "gl_slam_tpu_torch/csrc/nms.cu",
                 "gl_slam_tpu/ops/nms.py:86",
                 f"detector {CHUNK}x")):
            # the shapes of this slice's path: the chunk prologue's matcher
            # and assignment, the chunk's extraction
            head = next(r for r in rows if r["shape"].startswith(shape))
            kernels.append(dict(
                name=name, route="cuda", source=src, replaces=replaces,
                launches=path_launches[name], max_abs_err=err, ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                path=path, shape=head["shape"]))
        details["kernels"] = kernels
    except Failure as e:
        import shutil
        shutil.rmtree(os.path.join(out_dir, "kitti_cli"), ignore_errors=True)
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(dict(details, failure=str(e)), f, indent=1)
        return 1
    import shutil
    shutil.rmtree(os.path.join(out_dir, "kitti_cli"))   # keep what comes
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:  # back
        json.dump(details, f, indent=1)                            # small
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
