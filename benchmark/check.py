"""Whether what the timed path produced is correct.

Read once the window has closed: the benchmark copies what it judges off
the card (every stream's per-frame poses and verdicts, its BA-refined
keyframes and the features left in its state, and for a sample of
streams drawn from the seed the map arrays around the last BA pass), the
program's state is freed, and the plain reference (`reference/`)
recomputes the front end and the pair refinement of every stream's last
kept frame from the same images, and solves the sampled streams' last BA
window again from the map it started from.

Numbers compared, each held to a limit (value <= limit):
  * kpt_miss: the share of keypoints without a partner within 2.5 px in
    the other set (reference against the program's `prev_kpts`), the
    larger of the two directions: the CNN's heatmap and the NMS kernel;
  * desc_gap: the 99th percentile of 1 - cos between paired descriptors
    (`prev_desc`): the CNN's descriptor head and the sampling;
  * refine_gap_px: the 99th percentile of the distance between paired
    keypoints that the reference refined with the pair head: the matcher
    (attention and assignment kernels) and the pair head;
  * ba_cost_gap: the largest, over the sampled streams, share by which
    the robust cost of the program's BA result exceeds the cost that the
    reference's LM reaches on the same window problem from the same
    start: the batched BA (`reference/ba.py` states the problem);
  * ate_m: the largest, over streams, RMS distance (m) of the tracked
    frames' camera centres from the scene's ground truth, unaligned (the
    bootstrap takes the true scale): the matcher, RANSAC and pose LM;
  * kf_ate_m: the same of the BA-refined keyframes in the final map;
  * lost_pct: the share of tracked frames the program did not keep.
The first four have limits set from readings of the program and of the
controls (configuration file, `limits`); the last three are held to the
quality the configuration states (`guarantees`).
"""

from __future__ import annotations

import numpy as np

PAIR_RADIUS_PX = 2.5


def sample_streams(seed: int, S: int, k: int) -> list:
    rng = np.random.default_rng([int(seed), 7])
    return sorted(int(x) for x in rng.choice(S, size=min(k, S),
                                             replace=False))


def collect(program) -> dict:
    """Host copies of what the check judges (read after the window)."""
    import torch
    st = program.tracker.state
    m = st.map
    R = torch.cat([o[0] for o in program.outputs], 1).cpu().numpy()
    t = torch.cat([o[1] for o in program.outputs], 1).cpu().numpy()
    ok = torch.cat([o[2] for o in program.outputs], 1).cpu().numpy()
    nk = m.num_kf.cpu().numpy()
    top = int(nk.max())
    host = lambda d: {k: v.cpu().numpy() for k, v in d.items()}  # noqa
    return dict(R=R, t=t, ok=ok, num_kf=nk,
                kf_R=m.kf_R[:, :top].cpu().numpy(),
                kf_t=m.kf_t[:, :top].cpu().numpy(),
                kf_frame=m.kf_frame_idx[:, :top].cpu().numpy(),
                sample=list(program.sample),
                ba_in=host(program.ba_input), ba_out=host(program.ba_output),
                features=dict(kpts=st.prev_kpts.cpu().numpy(),
                              desc=st.prev_desc.float().cpu().numpy(),
                              valid=st.prev_valid.cpu().numpy()))


def last_pair(ok: np.ndarray) -> tuple:
    """(frame of the state's features, its pair partner): the last frame
    kept and the frame kept before it (frames 0 and 1 are the bootstrap's,
    kept; `ok` covers frames 2 on)."""
    kept = [0, 1] + [2 + i for i in np.nonzero(ok)[0]]
    return kept[-1], kept[-2]


def feature_pairs(ref, cand) -> dict:
    """Pair the valid keypoints of two sets by mutual nearest neighbour
    within PAIR_RADIUS_PX. ref/cand: (kpts, desc, valid[, refined]) as
    tensors on one device; the gaps come back as numpy arrays."""
    import torch
    rk, rd, rv = ref[:3]
    ck, cd, cv = cand[:3]
    ri, ci = torch.nonzero(rv)[:, 0], torch.nonzero(cv)[:, 0]
    if len(ri) == 0 or len(ci) == 0:
        return dict(miss=1.0, desc_gap=np.ones(1), refine=np.zeros(0))
    d = torch.cdist(rk[ri].double(), ck[ci].double())
    a = d.argmin(1)
    b = d.argmin(0)
    ar = torch.arange(len(ri), device=d.device)
    mutual = (b[a] == ar) & (d[ar, a] <= PAIR_RADIUS_PX)
    pr, pc = ri[mutual], ci[a[mutual]]
    n = int(mutual.sum())
    miss = max(1.0 - n / len(ri), 1.0 - n / len(ci))
    x, y = rd[pr].double(), cd[pc].double()
    cos = (x * y).sum(-1) / (x.norm(dim=-1) * y.norm(dim=-1)).clamp_min(1e-12)
    out = dict(miss=miss, desc_gap=(1.0 - cos).cpu().numpy(),
               refine=np.zeros(0))
    if len(ref) > 3:
        sel = ref[3][pr]
        out["refine"] = (rk[pr][sel].double() - ck[pc][sel].double()).norm(
            dim=-1).cpu().numpy()
    return out


def feature_numbers(per_stream: list) -> dict:
    """kpt_miss, desc_gap, refine_gap_px (and the widest gaps, printed
    beside them) over every stream's pairings."""
    gaps = np.concatenate([p["desc_gap"] for p in per_stream])
    ref = np.concatenate([p["refine"] for p in per_stream])
    return dict(
        kpt_miss=float(max(p["miss"] for p in per_stream)),
        desc_gap=float(np.percentile(gaps, 99)),
        desc_gap_max=float(gaps.max()),
        refine_gap_px=float(np.percentile(ref, 99)) if len(ref) else 0.0,
        refine_gap_max=float(ref.max()) if len(ref) else 0.0,
        refine_rows=int(len(ref)))


def reference_features(cell: dict, drive, col: dict, device,
                       fp8: bool = False) -> list:
    """The reference's features of every stream's last kept frame and the
    program's (or, with `fp8`, the control's) paired with them."""
    import torch
    from .harness import weight_paths
    from .reference import frontend as ref_fe
    from .reference import nets
    cfg = cell["config"]
    spec = dict(cfg["pipeline"])
    spec.update(stem_stride=cfg["networks"]["superpoint_stem_stride"],
                lightglue_heads=cfg["networks"]["lightglue_heads"],
                offset_range=cfg["networks"]["pair_head"]["offset_range"])
    patch = cfg["networks"]["pair_head"]["patch"]
    paths = weight_paths(cfg)
    w = {k: nets.load_npz(p, device) for k, p in paths.items()}
    f32 = nets.Ops(False)
    out = []
    with torch.no_grad():
        for s in range(col["ok"].shape[0]):
            k_last, k_prev = last_pair(col["ok"][s])
            idx = [drive.scene_frame(s, k) for k in (k_prev, k_last)]
            imgs = drive.frames[idx].to(device)
            feats = ref_fe.extract(w["sp"], imgs, spec, f32, patch)
            kp, refined = _refine(w, feats, spec, f32)
            ref = (kp, feats.desc[1], feats.valid[1], refined)
            if fp8:
                q = nets.Ops(True)
                qf = ref_fe.extract(w["sp"], imgs, spec, q, patch)
                qk, _ = _refine(w, qf, spec, q)
                cand = (qk, qf.desc[1], qf.valid[1])
            else:
                p = col["features"]
                cand = tuple(torch.from_numpy(p[k][s]).to(device)
                             for k in ("kpts", "desc", "valid"))
            out.append(feature_pairs(ref, cand))
    return out


def _refine(w, feats, spec, ops):
    """Frame 1 of a two-frame Features batch refined against frame 0."""
    from .reference import frontend as ref_fe
    a = ref_fe.Features(*(x[0:1] for x in feats))
    b = ref_fe.Features(*(x[1:2] for x in feats))
    return ref_fe.refine_pair(w["lg"], w["kspair"], a, b, 0, spec, ops)


def pose_numbers(col: dict, drive) -> dict:
    """ate_m, kf_ate_m (the largest over streams) and lost_pct."""
    S, n = col["ok"].shape
    ate, kf_ate = [], []
    for s in range(S):
        k = 2 + np.arange(n)
        ok = col["ok"][s]
        R, t = col["R"][s][ok], col["t"][s][ok]
        c = -np.einsum("kji,kj->ki", R, t)
        g = drive.gt_center(s, k[ok])
        ate.append(float(np.sqrt(((c - g) ** 2).sum(1).mean()))
                   if ok.any() else float("inf"))
        nk = int(col["num_kf"][s])
        Rk, tk = col["kf_R"][s, :nk], col["kf_t"][s, :nk]
        ck = -np.einsum("kji,kj->ki", Rk, tk)
        gk = drive.gt_center(s, col["kf_frame"][s, :nk])
        kf_ate.append(float(np.sqrt(((ck - gk) ** 2).sum(1).mean())))
    worst = np.argsort(ate)[::-1][:3]
    return dict(ate_m=float(max(ate)), kf_ate_m=float(max(kf_ate)),
                ate_m_median=float(np.median(ate)),
                ate_worst_streams=[[int(s), ate[s]] for s in worst],
                lost_pct=100.0 * float((~col["ok"]).sum()) / col["ok"].size)


def ba_spec(cell: dict) -> dict:
    p = cell["config"]["pipeline"]
    return dict(window=cell["traffic"]["chunk"] + p["full_ba_overlap"],
                max_window_cameras=p["max_window_cameras"],
                max_window_points=p["max_window_points"],
                gauge_fixed_cameras=p["gauge_fixed_cameras"],
                point_freeze_margin=p["point_freeze_margin"],
                cauchy=p["full_ba_cauchy_scale"])


def ba_numbers(col: dict, cell: dict, K: np.ndarray, device,
               tf32: bool = False) -> dict:
    """ba_cost_gap over the sampled streams' last BA pass: the program's
    result (or, with `tf32`, the reference's LM in TF32: the control)
    against the float64 reference from the same start. Beside it, the gap
    of the start itself (a pass that changed nothing) and the reference's
    iterations."""
    from .reference import ba as ref_ba
    spec = ba_spec(cell)
    gaps, starts, iters = [], [], []
    for i in range(len(col["sample"])):
        pre = {k: v[i] for k, v in col["ba_in"].items()}
        post = dict(pre, **{k: v[i] for k, v in col["ba_out"].items()})
        prob = ref_ba.window_problem(pre, spec, K, device)
        if not (bool(prob.cam_free.any()) and len(prob.cam)):
            continue
        x0 = ref_ba.state_of(prob, pre, device)
        *best, n = ref_ba.solve(prob, *x0)
        c_best = ref_ba.cost(prob, *best)
        cand = ref_ba.solve(prob, *x0, tf32_on=True)[:3] if tf32 \
            else ref_ba.state_of(prob, post, device)
        gaps.append((ref_ba.cost(prob, *cand) - c_best) / c_best)
        starts.append((ref_ba.cost(prob, *x0) - c_best) / c_best)
        iters.append(n)
    if not gaps:
        return dict(ba_cost_gap=float("inf"), ba_start_gap=float("inf"),
                    ba_ref_iters=[])
    return dict(ba_cost_gap=float(max(gaps)), ba_start_gap=float(min(starts)),
                ba_ref_iters=iters)


COMPARED = ("kpt_miss", "desc_gap", "refine_gap_px", "ba_cost_gap", "ate_m",
            "kf_ate_m", "lost_pct")


def verdict(numbers: dict, cfg_file: dict) -> tuple:
    """(correct, {name: [value, limit]}) of the compared numbers."""
    limits = dict(cfg_file["limits"])
    limits.update(cfg_file["guarantees"])
    checks = {k: [numbers[k], limits[k]] for k in COMPARED}
    ok = all(np.isfinite(v) and v <= lim for v, lim in checks.values())
    return bool(ok), checks
