"""Profile the chunked tracker once per tracker option on the card.

Runs `chip_smoke.py`'s phase 3 scenario (flagship width, 26 frames of the
rendered forward_turn scene, BA every 8, centroid refinement, loop closing
off, seed 0) through `run_learned_e2e`, first in the reference's
configuration ("separate") and with each option of `chip_smoke.py`
phase 9 (batched and merged re-observation, the PnP tracker, motion
gating at the default filters and at 1e6). The host's speed drifts within
a call, so each option's tracked fps is taken beside the reference's in
turns (separate, option, option, separate; unprofiled), after a warm-up
run of each; then one profiled run of the option gives the device busy
time, idle share, host ms by stage and launch calls (the reference is
profiled once, first). Prints one JSON line per configuration and writes
them all to --out.

    python scripts/profile_options_torch.py --out OPTIONS_PROFILE.json
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="OPTIONS_PROFILE.json")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_options_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gl_slam_tpu_torch.device import resolve_device
    from gl_slam_tpu_torch.ops import _build
    from gl_slam_tpu_torch.train import e2e

    card = cs.card_line()
    dev = resolve_device("cuda")
    _build.build_all()
    cfg, sp, lg, scene, stack = cs.setup_slice(dev)

    def runner(map_kw, rt_kw):
        ocfg = dataclasses.replace(
            cfg, map=dataclasses.replace(cfg.map, **map_kw),
            runtime=dataclasses.replace(cfg.runtime, **rt_kw))

        def once(diag):
            res = e2e.run_learned_e2e(sp, lg, scene, ocfg, cs.N_FRAMES,
                                      chunk=cs.CHUNK, ba_every=cs.CHUNK,
                                      device=dev, seed=0, stack=stack,
                                      diag_out=diag)
            torch.cuda.synchronize()
            return res
        return once

    tracked = cs.N_FRAMES - 2
    base = runner({}, {})
    base({})
    rows = []
    for name, map_kw, rt_kw in (("separate", {}, {}),) + cs.OPTION_RUNS:
        once = runner(map_kw, rt_kw)
        diag = {}
        res = once(diag)                     # warm-up, kept for its counts
        fps = [base({}).fps, once({}).fps, once({}).fps, base({}).fps]
        print(f"{name}: tracked fps separate/option/option/separate "
              f"{fps}", flush=True)
        prof = cs.profile_run(torch, lambda: once({}))
        row = dict(
            option=name, map=map_kw, runtime=rt_kw, card=card,
            fps_in_turns=fps, keyframes=res.num_keyframes,
            rejected=res.num_rejected,
            recovery_frames=len(diag["recovery_frames"]), ate_m=res.ate_m,
            mean_matches=res.mean_matches,
            device_idle_share=prof["device_idle_share"],
            profiled_wall_s=prof["profiled_wall_s"],
            device_busy_s=prof["device_busy_s"],
            launch_calls_per_frame=prof["launch_calls"] / tracked,
            sync_calls=prof["sync_calls"],
            host_ms_per_frame={k: v["host_ms"] / tracked
                               for k, v in prof["stages"].items()},
            own_kernel_ms=prof["own_kernel_ms"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
