#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gl_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # all phases, one card

Phases (any failure exits non-zero and prints no result line):
  1. build the hand-written CUDA kernels from gl_slam_tpu_torch/csrc/
     (one nvcc per source, in parallel) and print the card's name and power
     limit;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the tracker gives it (ragged masks, a fully masked row/column,
     constructed ties) within an elementwise error bound, and time kernel,
     plain version, a PyTorch library yardstick and the roofline bound;
  3. run the flagship-width chunked tracker (376x1241, N=2048, D=256, a
     9-layer 2-head LightGlue on all three per-frame passes, committed
     weights) over a bootstrap plus two chunks of 8 frames of a rendered
     scene, with BA and loop closing off and centroid sub-pixel refinement;
     check poses, matches, ATE and that the launch counters equal what the
     path implies.
The line before the last is the `kernels` JSON; the last line is the
device JSON. Details go to chiprun_out/chip_smoke.json.
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
PEAK_BYTES = 3.35e12

CHUNK = 8
N_FRAMES = 2 + 2 * CHUNK
# Kernel shapes on the flagship path: N keypoints per frame, M synthetic
# re-observation points, 2 heads of 128 dims, 256-d final projections.
N_KPTS, M_REOBS, HEADS, HEAD_DIM, FEAT_DIM = 2048, 1024, 2, 128, 256
# csrc/assignment.cu launches four kernels per call (row pass, column
# combine, argmax pass, argmax combine); attention.cu launches one.
ASSIGN_KERNELS_PER_CALL = 4


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
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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
    (8 pairs x 2 sets x 2 heads, 2048 x 2048) and the four re-observation
    calls (1 set x 2 heads, (Nq, Nk) in {1024, 2048}^2)."""
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
        q4, k4, v4 = (x.reshape(-1, H, *x.shape[-2:]) for x in (q, k, v))
        bias = torch.where(mask.reshape(-1, Nk), 0.0, -1e9).to(
            torch.bfloat16)[:, None, None, :]
        row = dict(
            shape=name, max_abs_err=err, max_err_over_bound=over,
            median_ref_over_bound=strength, masked_set_err_over_bound=uni_err,
            ms=time_ms(lambda: A.attention_cuda(q, k, v, mask, scale)),
            plain_ms=time_ms(lambda: A.attention_plain(q, k, v, mask, scale),
                             reps=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=bias, scale=scale)))
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
        report.append(row)
        del tol, diff
        print(f"  attention {name}: max|err| {err:.3g}, <= {over:.3g} x the "
              f"bound, median|ref| {strength:.3g} x the bound; kernel "
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
            (f"reobs 1x{M_REOBS}x{N_KPTS}", 1, M_REOBS, N_KPTS)):
        f0 = (rnd(B, N, FEAT_DIM) / 4).to(torch.bfloat16)
        f1 = (rnd(B, M, FEAT_DIM) / 4).to(torch.bfloat16)
        z0, z1 = rnd(B, N), rnd(B, M)
        m0 = torch.rand(B, N, generator=gen, device=dev) < 0.9
        m1 = torch.rand(B, M, generator=gen, device=dev) < 0.9
        m1[0, 7] = False                          # fully masked column
        m0[0, 3] = False                          # fully masked row
        # Row 40 strongly prefers column 100 and column 60 row 150; the
        # duplicates (column 200, row 300, with equal matchability) give
        # equal objectives, which must resolve to the smaller index.
        f1[0, 100] = f0[0, 40] * 4
        f0[0, 150] = f1[0, 60] * 4
        z1[0, 100] = z0[0, 150] = 5.0
        f1[0, 200], z1[0, 200] = f1[0, 100], z1[0, 100]
        f0[0, 300], z0[0, 300] = f0[0, 150], z0[0, 150]
        m0[0, [40, 150, 300]] = True
        m1[0, [60, 100, 200]] = True
        if B > 1:
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
        ref = AS.fused_reductions_plain(*args)
        torch.cuda.synchronize()
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
        flops = 2 * 2.0 * B * N * M * Df            # two passes of f0 f1^T
        nbytes = 2 * (f0.numel() + f1.numel()) + 5 * (B * N + B * M) \
            + 12 * (B * N + B * M)
        row = dict(
            shape=name, max_abs_err=err, tol=1e-3, index_diffs=n_diff,
            ms=time_ms(lambda: AS.fused_reductions_cuda(*args)),
            plain_ms=time_ms(lambda: AS.fused_reductions_plain(*args),
                             reps=5),
            library_ms=time_ms(lambda: torch.matmul(f0, f1.transpose(1, 2))))
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
        report.append(row)
        print(f"  assignment {name}: err {err:.3g} kernel {row['ms']:.4f} ms "
              f"plain {row['plain_ms']:.4f} ms bmm {row['library_ms']:.4f} "
              f"ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
              flush=True)
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the flagship-width slice

STAGES = ("extract", "prologue.match", "prologue.essential",
          "track.reobserve_window", "track.reobserve_covis", "track.pose_lm",
          "track.insert_keyframe")


def profile_run(torch, once):
    """Profile one run of the slice (bootstrap + chunks): device busy time
    and count of the device activities (kernels and copies), host time per
    pipeline stage from the stage markers, and the kernels with the most
    device time. The profiler slows the host, so stage times are read as
    shares of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, n_kernels, by_name, launches = 0.0, 0, {}, 0
    stages = {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if e.is_user_annotation:
            if e.name in STAGES and e.device_type != \
                    torch.autograd.DeviceType.CUDA:
                st = stages.setdefault(e.name, dict(host_ms=0.0, calls=0))
                st["host_ms"] += us / 1e3
                st["calls"] += 1
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += us
            n_kernels += 1
            name = e.name[:90]
            t, c = by_name.get(name, (0.0, 0))
            by_name[name] = (t + us, c + 1)
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                        "cudaLaunchKernelExC"):
            launches += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    # Busy and wall time of this one run. The profiler slows the host, so
    # this overstates the idle share of an unprofiled run.
    idle = 1.0 - busy_us / 1e6 / wall
    out = dict(profiled_wall_s=wall, device_busy_s=busy_us / 1e6,
               device_idle_share=idle, kernels=n_kernels,
               launch_calls=launches, stages=stages,
               top_kernels=[dict(name=k, ms=v[0] / 1e3, count=v[1])
                            for k, v in top])
    print(f"  profiled run: {wall:.3f} s wall, {n_kernels} device "
          f"activities, {launches} kernel launch calls, device "
          f"busy {busy_us / 1e6:.3f} s, idle share {idle:.3f}", flush=True)
    for k in STAGES:
        if k in stages:
            print(f"    {k}: host {stages[k]['host_ms']:.1f} ms over "
                  f"{stages[k]['calls']} calls")
    for row in out["top_kernels"][:8]:
        print(f"    {row['ms']:9.2f} ms {row['count']:6d}x {row['name']}")
    return out


def run_slice(torch, dev, details):
    import dataclasses

    import numpy as np

    from gl_slam_tpu_torch.config import flagship_config
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.train import e2e

    cfg = flagship_config()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, run_full_ba=False, loop_closing=False))
    check(cfg.frontend.subpix_source == "image", "centroid refinement")
    H, W = cfg.frontend.image_height, cfg.frontend.image_width
    t0 = time.perf_counter()
    sp, lg = e2e.load_flagship_frontend(os.path.join(ROOT, "checkpoints"),
                                        device=dev)
    scene = synthetic.make_scene(num_landmarks=20000, num_frames=N_FRAMES,
                                 height=H, width=W, seed=101,
                                 motion="forward_turn")
    stack = e2e.render_stack(scene, N_FRAMES, cfg.frontend.max_keypoints)
    print(f"  setup (weights + {N_FRAMES} rendered frames) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def once():
        return e2e.run_learned_e2e(sp, lg, scene, cfg, N_FRAMES, chunk=CHUNK,
                                   device=dev, seed=0, stack=stack,
                                   diag_out=diag)

    diag = {}
    t0 = time.perf_counter()
    once()                                   # warm-up: cuDNN plans, caches
    torch.cuda.synchronize()
    print(f"  warm-up run {time.perf_counter() - t0:.1f} s", flush=True)
    details["profile"] = profile_run(torch, once)

    diag = {}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = once()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"  bootstrap + {N_FRAMES - 2} frames (unprofiled): {run_s:.3f} s "
          f"wall", flush=True)
    o = diag["outputs"]
    tracked = N_FRAMES - 2
    # Matcher passes: the bootstrap's and each chunk prologue's (18
    # attention calls: 9 layers x self + cross), and two per frame (72:
    # 9 layers x 2 passes x (2 self + 2 cross, per set at its own size)).
    per_chunk_attn = 18 + CHUNK * 72
    want = {"attention": 18 + 2 * 18 + tracked * 72,
            "assignment": ASSIGN_KERNELS_PER_CALL * (1 + 2 + tracked * 2)}
    print(f"  frames {res.num_frames} keyframes {res.num_keyframes} "
          f"rejected {res.num_rejected} mean matches {res.mean_matches:.1f} "
          f"mean inliers {res.mean_inliers:.1f} ATE {res.ate_m:.4f} m "
          f"tracked fps {res.fps:.2f} launches {launches} "
          f"(expected {want})", flush=True)
    details["slice"] = dict(
        config="flagship_config(), run_full_ba=False, loop_closing=False, "
               "centroid subpix, make_scene(seed=101, num_landmarks=20000, "
               "motion='forward_turn') 376x1241",
        frames=res.num_frames, keyframes=res.num_keyframes,
        rejected=res.num_rejected, mean_matches=res.mean_matches,
        mean_inliers=res.mean_inliers, ate_m=res.ate_m, fps=res.fps,
        run_wall_s=run_s, launches=launches, expected_launches=want,
        attention_per_chunk=per_chunk_attn,
        num_matches=o.num_matches.tolist(),
        num_inliers=o.num_inliers.tolist(),
        num_map_matches=o.num_map_matches.tolist())
    check(np.isfinite(diag["R"]).all() and np.isfinite(diag["t"]).all(),
          "non-finite keyframe pose")
    check(np.isfinite(o.R).all() and np.isfinite(o.t).all(),
          "non-finite frame pose")
    check(res.num_rejected == 0 and res.num_keyframes == N_FRAMES,
          f"frames not kept: {res.num_keyframes} keyframes of {N_FRAMES}")
    check(res.mean_matches > 300, f"mean matches {res.mean_matches} <= 300")
    check(res.ate_m <= 1.0, f"ATE {res.ate_m} m > 1 m")
    check(launches == want, f"launch counts {launches} != {want}")
    return launches


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

        print("phase 2: kernels against their plain versions", flush=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        attn_rows, asg_rows = [], []
        attn_err = check_attention(torch, gen, dev, attn_rows)
        asg_err = check_assignment(torch, gen, dev, asg_rows)
        details["attention"] = attn_rows
        details["assignment"] = asg_rows

        print("phase 3: flagship-width chunked tracker", flush=True)
        launches = run_slice(torch, dev, details)

        kernels = []
        for name, rows, err, src, replaces in (
                ("attention", attn_rows, attn_err,
                 "gl_slam_tpu_torch/csrc/attention.cu",
                 "gl_slam_tpu/ops/attention.py:68"),
                ("assignment", asg_rows, asg_err,
                 "gl_slam_tpu_torch/csrc/assignment.cu",
                 "gl_slam_tpu/ops/assignment.py:128")):
            head = rows[0]                    # the prologue shape
            kernels.append(dict(
                name=name, route="cuda", source=src, replaces=replaces,
                launches=launches[name], max_abs_err=err, ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"]))
        details["kernels"] = kernels
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(dict(details, failure=str(e)), f, indent=1)
        return 1
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
