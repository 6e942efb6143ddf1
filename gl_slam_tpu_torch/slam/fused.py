"""Chunked pipeline: batched extraction, batched prologue, per-frame loop.

Counterpart of gl_slam_tpu/slam/fused.py (centroid sub-pixel refinement,
the pass-1 prologue without in-loop recovery), with extraction through the
NMS kernel as under the reference's `use_pallas_nms=True`. For a chunk of
T frames:

  1. the extractor runs batched over the T images;
  2. a prologue matches all T consecutive pairs at once (one LightGlue
     pass and one fused assignment over a pair axis) and runs their
     essential RANSACs batched;
  3. a Python loop runs the map-dependent tracking step frame by frame
     (two more LightGlue passes per frame for the re-observations).

After a rejected frame, every later frame of the chunk is rejected too
(its precomputed pair is stale), as the JAX version does under
every-frame keyframing; the recovery path of motion-gated keyframing is
not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..config import SLAMConfig
from ..geometry import essential as essential_mod
from ..models.lightglue import normalize_keypoints
from ..models.subpix import centroid_refine
from ..models.superpoint import sample_descriptors
from ..ops import assignment as assignment_ops
from ..ops import match as match_ops
from ..ops import nms as nms_ops
from . import frontend


def detector_heatmap(cfg: SLAMConfig, sp_net, images):
    """images (B, H, W) in [0, 1] -> (heat (B, H8, W8) float32 with the
    padding up to multiples of 8 zeroed, descriptor grid)."""
    H, W = cfg.frontend.image_height, cfg.frontend.image_width
    x = F.pad(images, (0, (-W) % 8, 0, (-H) % 8))[..., None]
    heat, grid = sp_net(x)
    dev = heat.device
    row_ok = torch.arange(heat.shape[1], device=dev) < H
    col_ok = torch.arange(heat.shape[2], device=dev) < W
    return heat * row_ok[None, :, None] * col_ok[None, None, :], grid


def build_extract_fn(cfg: SLAMConfig, sp_net):
    """fn(images (B, H, W) in [0, 1]) -> (kpts (B, N, 2), desc (B, N, D),
    valid (B, N)): CNN forward, NMS + top-K, centroid refinement and
    descriptor sampling. On the card the NMS is the hand-written kernel
    (ops/nms.nms dispatches on the heatmap's device)."""
    N = cfg.frontend.max_keypoints

    def extract_batch(images):
        heat, grid = detector_heatmap(cfg, sp_net, images)
        kpts, _, valid = nms_ops.detect_keypoints(
            heat, N, cfg.frontend.score_threshold, cfg.frontend.nms_radius)
        kpts = kpts.float()
        src = images if cfg.frontend.subpix_source == "image" else heat
        kpts = centroid_refine(src, kpts, cfg.frontend.subpix_patch)
        return kpts, sample_descriptors(grid, kpts), valid

    return extract_batch


def build_matcher(cfg: SLAMConfig, lg_net):
    """The learned matcher: LightGlue features + the fused assignment.
    fn(kpts0, desc0, valid0, kpts1, desc1, valid1) -> MatchResult, with
    optional leading batch dimensions."""
    H, W = cfg.frontend.image_height, cfg.frontend.image_width
    scale = 1.0 / float(lg_net.dim) ** 0.5

    def lg_match(kpts0, desc0, valid0, kpts1, desc1, valid1):
        f0, f1, z0, z1 = lg_net(desc0, desc1,
                                normalize_keypoints(kpts0, H, W),
                                normalize_keypoints(kpts1, H, W),
                                valid0, valid1, return_features=True)
        mo = assignment_ops.fused_assignment(f0, f1, z0, z1, valid0, valid1,
                                             scale, 0.0)
        return match_ops.MatchResult(matches0=mo.matches0,
                                     mscores0=mo.mscores0)

    return lg_match


def build_chunk_fn(cfg: SLAMConfig, sp_net, lg_net, K, chunk: int):
    """fn(state, images (T, H, W), frame_idx0, u (T, hypotheses, 8)) ->
    (state, list of T TrackOutputs). `u` holds each pair's RANSAC draws."""
    frontend._check_supported(cfg)
    g = cfg.geometry
    extract_batch = build_extract_fn(cfg, sp_net)
    lg_match = build_matcher(cfg, lg_net)
    reobs_matcher = lg_match if cfg.frontend.reobs_matcher == "lightglue" \
        else None

    def chunk_fn(state: frontend.TrackState, images, frame_idx0: int, u):
        with record_function("extract"):
            kpts_b, desc_b, valid_b = extract_batch(images)
        # Pair t = (frame t-1, frame t); pair 0 uses the stored
        # last-accepted features.
        kp0_b = torch.cat([state.prev_kpts[None], kpts_b[:-1]])
        d0_b = torch.cat([state.prev_desc[None], desc_b[:-1]])
        v0_b = torch.cat([state.prev_valid[None], valid_b[:-1]])
        with record_function("prologue.match"):
            m_b = lg_match(kp0_b, d0_b, v0_b, kpts_b, desc_b, valid_b)
        pairf = match_ops.score_filter(m_b.matches0, m_b.mscores0,
                                       cfg.frontend.match_threshold)
        uv0, uv1, pairf = match_ops.gather_matched(kp0_b, kpts_b,
                                                   m_b.matches0, pairf)
        with record_function("prologue.essential"):
            ess_b = essential_mod.estimate_essential(
                K, uv0, uv1, pairf, u,
                threshold_px=g.essential_threshold_px,
                num_hypotheses=g.essential_hypotheses,
                refine_iters=g.essential_refine_iters)

        outs = []
        ok_prev = torch.ones((), dtype=torch.bool, device=kpts_b.device)
        frame_ids = torch.arange(frame_idx0, frame_idx0 + chunk,
                                 dtype=torch.int32, device=kpts_b.device)
        for i in range(chunk):
            f = frontend.FrameFeatures(
                kpts=kpts_b[i], desc=desc_b[i], valid=valid_b[i],
                frame_idx=frame_ids[i])
            m = match_ops.MatchResult(matches0=m_b.matches0[i],
                                      mscores0=m_b.mscores0[i])
            ess = essential_mod.EssentialResult(*(x[i] for x in ess_b))
            state, out = frontend.track_step_impl(
                cfg, K, state, f, matches=m, ess_result=ess,
                matcher=reobs_matcher, accept_gate=ok_prev)
            ok_prev = out.frame_ok
            outs.append(out)
        return state, outs

    return chunk_fn
