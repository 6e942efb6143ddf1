"""Aggregate tracked fps of S streams on one card: batched on the stream
axis against time-multiplexed.

The counterpart of `bench.py --ms-econ` (MS_ECON.json) for the port, at
flagship width (chip_smoke.py phase 3's configuration: flagship_config(),
centroid refinement, loop closing off, a window BA pass after every chunk
of 8) on a rendered forward_turn scene (seed 101), stream s tracking its
frames from offset s. For S in --streams, two ways of running S streams:

  * batched: one multi-stream chunk per chunk of 8 frames
    (slam/fused.build_multistream_chunk_fn, every kernel launch covering
    all S streams) and one stream-batched BA pass
    (MultiStreamTracker.ba);
  * time-multiplexed: S single-stream chunks back to back, then S BA
    passes, as `bench.py`'s `run_multi`.

Both start from the same bootstrapped states (MultiStreamTracker's
bootstrap, untimed) and run --chunks chunks with a BA pass after each;
aggregate fps = S x 8 x chunks / wall time, the wall ending in a
synchronisation. The host's speed drifts within a call and between calls
(~30 %), so the two ways are timed in turns (batched first on even turns,
time-multiplexed first on odd ones) after a warm-up of each, and each
figure is the median over --turns. A profiled batched run per S gives the
device's idle share and the launch calls per tracked frame (the
time-multiplexed launch calls per frame are the single-stream run's,
profiled at S = 1); the peak memory of each timed run comes from
torch.cuda.max_memory_allocated.

Writes --out (MS_ECON_TORCH.json) with MS_ECON.json's keys (the
time-multiplexed aggregates) plus `batched_aggregate_fps_by_streams`, the
card's name and power limit beside every number. The peak memory of each
timed run includes the bootstrapped states of every S, held throughout
(`resident_bytes`).

    python scripts/profile_multistream_torch.py --out MS_ECON_TORCH.json
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="MS_ECON_TORCH.json")
    ap.add_argument("--streams", default="1,2,4,8,16")
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_multistream_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gl_slam_tpu_torch.device import resolve_device
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.parallel.multistream import MultiStreamTracker
    from gl_slam_tpu_torch.slam import ba as ba_mod
    from gl_slam_tpu_torch.slam import fused
    from gl_slam_tpu_torch.slam.state import _at, tree_map
    from gl_slam_tpu_torch.train import e2e

    card = cs.card_line()
    name, power = [x.strip() for x in card.split(",")]
    dev = resolve_device("cuda")
    _build.build_all()
    streams = [int(x) for x in args.streams.split(",")]
    T, C = cs.CHUNK, args.chunks
    cfg, sp, lg, _, _ = cs.setup_slice(dev)
    H, W = cfg.frontend.image_height, cfg.frontend.image_width
    n_frames = max(streams) - 1 + 2 + C * T
    scene = synthetic.make_scene(num_landmarks=20000, num_frames=n_frames,
                                 height=H, width=W, seed=101,
                                 motion="forward_turn")
    frames = torch.from_numpy(e2e.render_stack(
        scene, n_frames, cfg.frontend.max_keypoints)).to(dev)
    K = torch.as_tensor(scene.K, dtype=torch.float32, device=dev)
    hyp = cfg.geometry.essential_hypotheses
    extract = fused.build_extract_fn(cfg, sp)
    single_fn = fused.build_chunk_fn(cfg, sp, lg, K, T)
    win_kf = T + cfg.ba.full_ba_overlap

    def chunk_images(S, c):
        a = 2 + c * T
        return torch.stack([frames[s + a:s + a + T] for s in range(S)])

    def bootstrap(S):
        """S bootstrapped streams (stream s on frames s, s + 1) and each
        stream's chunk draws (S, C, T, hyp, 8)."""
        tr = MultiStreamTracker(cfg, scene.K, S, device=dev, seed=0)
        feats = [extract(frames[s:s + 2]) for s in range(S)]
        f0, f1 = ([torch.stack([f[k][i] for f in feats]) for k in range(3)]
                  for i in (0, 1))
        scales = []
        for s in range(S):
            c = [-scene.poses_R[i].T @ scene.poses_t[i] for i in (s, s + 1)]
            scales.append(float(np.linalg.norm(c[1] - c[0])))
        tr.bootstrap(f0, f1, scales)
        g = torch.Generator(device=dev).manual_seed(S)
        u = torch.rand((S, C, T, hyp, 8), generator=g, device=dev)
        # the same bootstrapped streams, one unbatched state each
        singles = [tree_map(lambda x, s=s: x[s].contiguous(), tr.state)
                   for s in range(S)]
        torch.cuda.synchronize()
        return tr, u, singles

    def window(nk):
        first = torch.clamp_min(nk - win_kf, 0)
        return first, nk - first

    def batched(S, boot, n_chunks=C):
        tr0, u, _ = boot
        tr = MultiStreamTracker(cfg, scene.K, S, device=dev)
        tr.state = tr0.state
        fn = fused.build_multistream_chunk_fn(cfg, sp, lg, scene.K, T, S)
        for c in range(n_chunks):
            st, _, _ = fn(tr.state, chunk_images(S, c), 2 + c * T, u[:, c])
            tr.state = st
            tr.ba(*window(st.map.num_kf))
        return tr

    def multiplexed(S, boot, n_chunks=C):
        _, u, states = boot
        states = list(states)
        for c in range(n_chunks):
            imgs = chunk_images(S, c)
            for s in range(S):
                states[s], _, _ = single_fn(states[s], imgs[s], 2 + c * T,
                                            u[s, c])
            for s in range(S):
                m = ba_mod.ba_step(cfg, K, states[s].map,
                                   *window(states[s].map.num_kf))
                idx = torch.clamp(m.num_kf - 1, 0, m.capacity_kf - 1)
                states[s] = states[s]._replace(
                    map=m, R_cur=_at(m.kf_R, idx), t_cur=_at(m.kf_t, idx))
        return states

    def timed(fn, S, boot):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn(S, boot)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return S * T * C / wall, torch.cuda.max_memory_allocated()

    def state_bytes(st):
        return sum(x.numel() * x.element_size() for x in
                   (*st.map, *st[1:]) if torch.is_tensor(x))

    boots = {S: bootstrap(S) for S in streams}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    multiplexed(1, boots[1], 1)                  # warm-up
    for S in streams:
        batched(S, boots[S], 1)
    torch.cuda.synchronize()
    print(f"warm-up {time.perf_counter() - t0:.1f} s", flush=True)

    runs = {S: dict(batched=[], multiplexed=[], batched_peak=0,
                    multiplexed_peak=0) for S in streams}
    for turn in range(args.turns):
        for S in streams:
            order = (("batched", batched), ("multiplexed", multiplexed))
            if turn % 2:
                order = order[::-1]
            for mode, fn in order:
                fps, peak = timed(fn, S, boots[S])
                runs[S][mode].append(fps)
                runs[S][f"{mode}_peak"] = max(runs[S][f"{mode}_peak"], peak)
                print(f"turn {turn} S={S} {mode}: {fps:.3f} fps aggregate, "
                      f"peak {peak / 2**20:.0f} MiB [{name}, {power}]",
                      flush=True)

    profiles = {}
    for S in streams:
        prof = cs.profile_run(torch, lambda S=S: batched(S, boots[S]))
        profiles[S] = dict(
            device_idle_share=prof["device_idle_share"],
            device_busy_s=prof["device_busy_s"],
            launch_calls_per_frame=prof["launch_calls"] / (S * T * C),
            own_kernel_ms=prof["own_kernel_ms"])
    prof = cs.profile_run(torch, lambda: multiplexed(1, boots[1]))
    mux_launches = prof["launch_calls"] / (T * C)

    med = {S: {m: statistics.median(runs[S][m])
               for m in ("batched", "multiplexed")} for S in streams}
    single = med[1]["multiplexed"] if 1 in med else None
    table = {
        "config": ("flagship_config() at 376x1241, N=2048, 9-layer LightGlue "
                   "on every pass, centroid subpix, window BA after every "
                   "chunk of 8, loop closing off; rendered forward_turn "
                   "scene (seed 101), stream s from frame s; aggregate fps "
                   f"across all streams over {C} chunks, median of "
                   f"{args.turns} turns; time-multiplexed = S single-stream "
                   "chunks back to back, batched = one multi-stream chunk "
                   "on the stream axis"),
        "card": name, "power_limit": power,
        "single_stream_fps": single,
        "aggregate_fps_by_streams": {
            str(S): med[S]["multiplexed"] for S in streams if S > 1},
        "per_stream_fps_by_streams": {
            str(S): med[S]["multiplexed"] / S for S in streams if S > 1},
        "batched_aggregate_fps_by_streams": {
            str(S): med[S]["batched"] for S in streams},
        "runs_fps": {str(S): {m: runs[S][m] for m in
                              ("batched", "multiplexed")} for S in streams},
        "peak_allocated_bytes": {
            str(S): {m: runs[S][f"{m}_peak"] for m in
                     ("batched", "multiplexed")} for S in streams},
        # resident during every timed run: the bootstrapped states of
        # every S, batched and one unbatched copy per stream
        "resident_bytes": resident,
        "state_bytes_per_stream": state_bytes(boots[streams[0]][2][0]),
        "batched_profile": {str(S): p for S, p in profiles.items()},
        "multiplexed_launch_calls_per_frame": mux_launches,
    }
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1)
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
