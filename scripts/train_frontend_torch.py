"""Train the learned front-end on the PyTorch/CUDA port: SuperPoint, the
single-view and the pair sub-pixel heads, then LightGlue, on rendered
synthetic scenes (gl_slam_tpu_torch/train/frontend_train.py), on the card
by default. The counterpart of scripts/train_frontend.py, with its presets.

The weights are written as flat .npz files in the JAX package's layout
(checkpoint.save_params: {sp,ks,kspair,lg}_<preset>.npz), which both
packages load. `--out` defaults to trained_torch/ (git-ignored) and may not
be the repository's checkpoints/: the committed checkpoints back the tests
and the reports.

`--track-report PATH` then tracks the held-out scene of
tests/test_learned_e2e.py::test_learned_pipeline_tracks (240x320, N 128,
make_scene(num_landmarks=900, num_frames=32, seed=11), micro_config) with
the port's run_learned_e2e on the new weights and on the committed ones,
and writes one JSON report: per trainer its steps, wall time, ms a step
and first and last loss, per weight set ATE, keyframes, mean matches and
BA runs, and the card's name and power limit (tiny preset only).

    python scripts/train_frontend_torch.py --preset tiny
    python scripts/train_frontend_torch.py --preset tiny \
        --out chiprun_out/trained \
        --track-report chiprun_out/TRAIN_TINY_TORCH.json
    python scripts/train_frontend_torch.py --preset flagship --lg-only
    python scripts/train_frontend_torch.py --preset tiny --sp-steps 5 \
        --subpix-steps 5 --pair-steps 5 --lg-steps 5 --device cpu
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PRESETS = {
    # (H, W, N, D, sp_channels, lg_dim, lg_heads, lg_layers,
    #  sp_steps, lg_steps, landmarks): scripts/train_frontend.py's
    "tiny": (160, 240, 96, 64, (16, 16, 32, 32, 32, 32, 64, 64),
             64, 2, 2, 1500, 800, 700),
    "flagship": (376, 1240, 2048, 256, (64, 64, 64, 64, 128, 128, 128, 128),
                 256, 2, 9, 3000, 1500, 20000),
}
SUBPIX_STEPS, PAIR_STEPS = 500, 600
DEFAULT_OUT = os.path.join(ROOT, "trained_torch")


def checked_out_dir(out: str) -> str:
    """`out`, unless it resolves to the repository's checkpoints/ or a
    directory inside it (raises ValueError)."""
    committed = os.path.realpath(os.path.join(ROOT, "checkpoints"))
    real = os.path.realpath(out)
    if os.path.commonpath([real, committed]) == committed:
        raise ValueError(f"--out {out} is the repository's checkpoints/, "
                         f"whose committed weights back the tests; write "
                         f"elsewhere (default {DEFAULT_OUT})")
    return out


def track_held_out(sp, lg, device) -> dict:
    """tests/test_learned_e2e.py::test_learned_pipeline_tracks' scenario
    with the port's run_learned_e2e."""
    from gl_slam_tpu_torch.config import TINY_DESC_DIM, micro_config
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.train import e2e
    H, W, N, D = 240, 320, 128, TINY_DESC_DIM
    scene = synthetic.make_scene(num_landmarks=900, num_frames=32, height=H,
                                 width=W, desc_dim=D, seed=11)
    res = e2e.run_learned_e2e(sp.eval(), lg.eval(), scene,
                              micro_config(H, W, N, D), n_frames=32,
                              device=device)
    return dict(ate_m=res.ate_m, num_keyframes=res.num_keyframes,
                num_frames=res.num_frames, mean_matches=res.mean_matches,
                num_ba_runs=res.num_ba_runs, num_rejected=res.num_rejected)


def evaluate(sp, ks, kp, H, W, N, D, landmarks, device):
    """Detection recall at 2 px and the median refined-keypoint error of
    the centroid, the single-view and the pair head on 6 frames of a
    held-out scene (scripts/train_frontend.py --eval)."""
    import torch
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.models.subpix import (centroid_refine,
                                                 gather_patches)
    from gl_slam_tpu_torch.models.superpoint import sample_descriptors
    from gl_slam_tpu_torch.ops import nms as nms_ops
    test = synthetic.make_scene(num_landmarks=landmarks, num_frames=6,
                                height=H, width=W, desc_dim=D, seed=11)
    nm = ng = 0
    errs_c, errs_k, errs_p = [], [], []
    prev = None     # (anchor, patches, desc, lids) of the previous frame
    with torch.no_grad():
        for i in range(6):
            obs = synthetic.observe_frame(test, i, max_keypoints=N)
            img = torch.from_numpy(synthetic.render_frame(
                test, i, max_keypoints=N).astype(np.float32)).to(device)
            heat, grid = sp(img[None, ..., None])
            kp_det, _, v = nms_ops.detect_keypoints(heat, N, 1e-3, 3)
            kpi = kp_det[0].float()
            kpr_c = centroid_refine(img, kpi, 7)
            d_int = sample_descriptors(grid[0], kpi)
            kpr_k = (kpi + ks(gather_patches(img, kpi, ks.patch),
                              d_int)).cpu().numpy()
            kpr_c, vv = kpr_c.cpu().numpy(), v[0].cpu().numpy()
            gt = obs.keypoints[obs.valid]
            gt_lid = obs.landmark_ids[obs.valid]
            ng += len(gt)
            for kpr, errs in ((kpr_c, errs_c), (kpr_k, errs_k)):
                dr = np.linalg.norm(kpr[vv][:, None, :] - gt[None, :, :],
                                    axis=2).min(axis=1)
                errs.extend(dr[dr < 2])
            nm += (np.linalg.norm(kpr_c[vv][:, None, :] - gt[None, :, :],
                                  axis=2).min(axis=1) < 2).sum()
            # pair-conditioned: oracle-match detections against prev frame
            anchor = np.round(kpr_c)
            patches = gather_patches(img, torch.from_numpy(anchor).to(
                device), kp.patch).cpu().numpy()
            desc = sample_descriptors(grid[0], torch.from_numpy(kpr_c).to(
                device)).cpu().numpy()
            dmat = np.linalg.norm(kpr_c[:, None, :] - gt[None, :, :], axis=2)
            jn = dmat.argmin(axis=1) if len(gt) else np.zeros(N, int)
            det_ok = vv & (dmat.min(axis=1) < 2.0) if len(gt) \
                else np.zeros(N, bool)
            lids = np.where(det_ok, gt_lid[jn], -1)
            gt_of = {int(l): g for l, g in zip(gt_lid, gt)}
            if prev is not None:
                lut = {int(l): k for k, l in enumerate(lids) if l >= 0}
                r0 = [k for k, l in enumerate(prev[3])
                      if l >= 0 and int(l) in lut]
                r1 = [lut[int(prev[3][k])] for k in r0]
                if r0:
                    r0, r1 = np.asarray(r0), np.asarray(r1)
                    score = np.clip(np.sum(prev[2][r0] * desc[r1], 1), 0, 1)
                    t = lambda a: torch.from_numpy(
                        np.ascontiguousarray(a, np.float32)).to(device)
                    off = kp(t(prev[1][r0]), t(patches[r1]), t(prev[2][r0]),
                             t(desc[r1]), t(score)).cpu().numpy()
                    ref = anchor[r1] + off
                    gtt = np.stack([gt_of[int(l)] for l in lids[r1]])
                    errs_p.extend(np.linalg.norm(ref - gtt, axis=1))
            prev = (anchor, patches, desc, lids)
    print(f"detection: recall@2px {nm}/{ng}; refined median err: "
          f"centroid {np.median(errs_c):.3f}px, "
          f"learned-subpix {np.median(errs_k):.3f}px, "
          f"pair-subpix {np.median(errs_p):.3f}px")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--sp-steps", type=int, default=None)
    ap.add_argument("--subpix-steps", type=int, default=SUBPIX_STEPS)
    ap.add_argument("--pair-steps", type=int, default=PAIR_STEPS)
    ap.add_argument("--lg-steps", type=int, default=None)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--eval", action="store_true",
                    help="report detection/matching quality on held-out data")
    ap.add_argument("--lg-only", action="store_true",
                    help="retrain ONLY the matcher, loading sp_<preset>.npz "
                         "from --out")
    ap.add_argument("--desc-age-max", type=int, default=6,
                    help="descriptor-age augmentation bound for the "
                         "matcher (see train_lightglue)")
    ap.add_argument("--track-report", default=None,
                    help="write the held-out tracking report here (tiny "
                         "preset)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    out = checked_out_dir(args.out)
    if args.track_report and args.preset != "tiny":
        raise ValueError("--track-report runs the tiny preset's scenario")

    import torch
    from gl_slam_tpu_torch import checkpoint as ckpt
    from gl_slam_tpu_torch.device import resolve_device
    from gl_slam_tpu_torch.io import synthetic
    from gl_slam_tpu_torch.models.lightglue import LightGlueNet
    from gl_slam_tpu_torch.models.subpix import PairSubpixHead, SubpixHead
    from gl_slam_tpu_torch.models.superpoint import SuperPointNet
    from gl_slam_tpu_torch.train import frontend_train as ft

    dev = resolve_device(args.device)
    (H, W, N, D, ch, lgd, lgh, lgl, sp_steps, lg_steps,
     landmarks) = PRESETS[args.preset]
    sp_steps = args.sp_steps or sp_steps
    lg_steps = args.lg_steps or lg_steps
    scenes = [synthetic.make_scene(num_landmarks=landmarks, num_frames=36,
                                   height=H, width=W, desc_dim=D,
                                   seed=args.seed + 10 * s)
              for s in range(6 if args.preset == "tiny" else 3)]
    sp = SuperPointNet(descriptor_dim=D, channels=ch)
    lg = LightGlueNet(dim=lgd, heads=lgh, layers=lgl, input_dim=D)
    ks = SubpixHead(D, patch=7, offset_range=1.5)
    kp = PairSubpixHead(D, patch=7, offset_range=1.5)
    report = {"preset": args.preset, "seed": args.seed, "trainers": {}}
    # step counts cut below the preset's, each listed
    full = {"sp_steps": PRESETS[args.preset][8], "subpix_steps": SUBPIX_STEPS,
            "pair_steps": PAIR_STEPS, "lg_steps": PRESETS[args.preset][9]}
    ran = {"sp_steps": sp_steps, "subpix_steps": args.subpix_steps,
           "pair_steps": args.pair_steps, "lg_steps": lg_steps}
    report["reduced"] = [f"{k} {ran[k]} of {full[k]}" for k in full
                         if ran[k] < full[k]]

    def run(name, fn, *a, **kw):
        stats = {}
        t0 = time.perf_counter()
        fn(*a, device=dev, stats=stats, **kw)
        stats["wall_s"] = time.perf_counter() - t0
        report["trainers"][name] = stats
        print(f"{name} trained in {stats['wall_s']:.1f}s ({stats['steps']} "
              f"steps, {stats['step_ms']} ms a step after the first; loss "
              f"{stats['first_loss']:.4f} -> {stats['last_loss']:.4f})",
              flush=True)

    if args.lg_only:
        ckpt.load_module(sp, ckpt.params_path(out, f"sp_{args.preset}"),
                         ckpt.superpoint_state_dict)
        sp.to(dev)
    else:
        run("superpoint", ft.train_superpoint, sp, scenes, 30, N,
            steps=sp_steps, batch_size=4, log_every=200)
        sp.eval()
        run("subpix", ft.train_subpix, ks, sp, scenes, 20, N,
            steps=args.subpix_steps, log_every=200)
        run("pair_subpix", ft.train_pair_subpix, kp, sp, scenes, 20, N,
            steps=args.pair_steps, log_every=200)
    run("lightglue", ft.train_lightglue, lg, sp, scenes, 30, N,
        steps=lg_steps, batch_size=2, jitter_px=1.0, log_every=200,
        desc_age_max=args.desc_age_max)

    os.makedirs(out, exist_ok=True)
    nets = {"lg": lg} if args.lg_only else {"lg": lg, "sp": sp, "ks": ks,
                                            "kspair": kp}
    for tag, module in nets.items():
        ckpt.save_params(ckpt.params_path(out, f"{tag}_{args.preset}"),
                         module)
    print(f"saved checkpoints for preset {args.preset} to {out}")

    if args.eval and not args.lg_only:
        evaluate(sp.eval(), ks.eval(), kp.eval(), H, W, N, D, landmarks,
                 dev)
    if args.track_report:
        from gl_slam_tpu_torch.train import e2e, evals
        report["device"] = evals.device_line(dev)
        report["torch"] = torch.__version__
        report["held_out"] = (
            "tests/test_learned_e2e.py::test_learned_pipeline_tracks: "
            "240x320, N 128, make_scene(num_landmarks=900, num_frames=32, "
            "seed=11), micro_config, run_learned_e2e(chunk=5, ba_every=3)")
        report["trained"] = track_held_out(sp, lg, dev)
        csp, clg = e2e.load_tiny_frontend(os.path.join(ROOT, "checkpoints"),
                                          device=dev)
        report["committed"] = track_held_out(csp, clg, dev)
        for name in ("trained", "committed"):
            print(f"held-out tracking, {name} weights: "
                  f"{json.dumps(report[name])}", flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.track_report)),
                    exist_ok=True)
        with open(args.track_report, "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps(report))


if __name__ == "__main__":
    main()
