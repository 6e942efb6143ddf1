"""Chunked pipeline: batched extraction, batched prologue, per-frame loop.

Counterpart of gl_slam_tpu/slam/fused.py (centroid, single-view learned
or pair-conditioned sub-pixel refinement, the pass-1 prologue with and
without in-loop recovery), with extraction through the NMS kernel as under
the reference's `use_pallas_nms=True`. For a chunk of T frames:

  1. the extractor runs batched over the T images (and the single-view
     head, when given, refines each detection there);
  2. a prologue matches all T consecutive pairs at once (one LightGlue
     pass and one fused assignment over a pair axis), refines the current
     keypoints with the pair head when one is given, and runs the pairs'
     essential RANSACs batched (none under the PnP tracker);
  3. a Python loop runs the map-dependent tracking step frame by frame
     (two more LightGlue passes per frame for the re-observations, or one
     in the merged and batched modes).

A frame after a rejected one finds its precomputed pair stale. Under
every-frame keyframing it is rejected too, and so is the rest of the
chunk; under motion-gated keyframing, where rejections are routine, the
frame is matched again against the last accepted features (the
recovery branch, taken on the host). A `frame_gate` lets the chunk
driver (slam/chunk_driver.py) feed a padded tail chunk: its padding
frames run the whole step but are never accepted.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..config import SLAMConfig
from ..geometry import essential as essential_mod
from ..models.lightglue import normalize_keypoints
from ..models.subpix import (PairSubpixHead, SubpixHead, centroid_refine,
                             gather_patches, pair_refine_scatter)
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


def _pair_mode(subpix_head) -> bool:
    """True for a PairSubpixHead, False for None or a SubpixHead."""
    if subpix_head is None or isinstance(subpix_head, SubpixHead):
        return False
    if not isinstance(subpix_head, PairSubpixHead):
        raise TypeError(f"subpix_head must be a SubpixHead or a "
                        f"PairSubpixHead, not {type(subpix_head).__name__}")
    return True


def build_extract_fn(cfg: SLAMConfig, sp_net, subpix_head=None):
    """fn(images (B, H, W) in [0, 1]) -> (kpts (B, N, 2), desc (B, N, D),
    valid (B, N)): CNN forward, NMS + top-K, sub-pixel refinement and
    descriptor sampling. On the card the NMS is the hand-written kernel
    (ops/nms.nms dispatches on the heatmap's device).

    The refinement is the centroid, or with a SubpixHead the learned
    single-view offset: the head reads the (P, P) image patch and the
    descriptor at each integer detection, and the descriptors are sampled
    again at the refined points.

    With a PairSubpixHead the per-frame refinement here stays the centroid:
    the learned refinement is pair-conditioned and runs on matched
    keypoints in build_chunk_fn's prologue; a fourth output holds the
    (B, N, P, P) image patches around round(kpts) that the head reads."""
    N = cfg.frontend.max_keypoints
    pair_mode = _pair_mode(subpix_head)
    single_mode = subpix_head is not None and not pair_mode

    def extract_batch(images):
        heat, grid = detector_heatmap(cfg, sp_net, images)
        kpts, _, valid = nms_ops.detect_keypoints(
            heat, N, cfg.frontend.score_threshold, cfg.frontend.nms_radius)
        kpts = kpts.float()
        if single_mode:
            patches = gather_patches(images, kpts, subpix_head.patch)
            kpts = kpts + subpix_head(patches,
                                      sample_descriptors(grid, kpts))
        else:
            src = images if cfg.frontend.subpix_source == "image" else heat
            kpts = centroid_refine(src, kpts, cfg.frontend.subpix_patch)
        desc = sample_descriptors(grid, kpts)
        if pair_mode:
            return kpts, desc, valid, gather_patches(
                images, torch.round(kpts), subpix_head.patch)
        return kpts, desc, valid

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


def build_chunk_fn(cfg: SLAMConfig, sp_net, lg_net, K, chunk: int,
                   subpix_head=None, prologue: bool = True):
    """fn(state, images (T, H, W), frame_idx0, u (T, hypotheses, 8),
    frame_gate=None, pnp_gumbel=None) -> (state, list of T TrackOutputs,
    list of T bools: the frames whose pass-1 match took the recovery
    branch). `u` holds each pair's RANSAC draws; under the PnP tracker no
    RANSAC runs in the prologue, `u` may be None, and `pnp_gumbel`
    (T, pnp_hypotheses, N) holds each frame's PnP RANSAC draws.

    `frame_gate` (T,) bool force-rejects the frames where it is False (ANDed
    into the acceptance gate): a driver pads a partial tail chunk with
    copies of its last real frame and gates the copies off. Gated frames
    still run the whole step, matcher passes included. Padding only ever
    trails real frames, so a gated frame leaves the chain of acceptances
    (`ok_prev`) as it was.

    A frame that follows a rejected one finds its precomputed pair stale
    (matched against the rejected frame). What happens then follows the
    keyframe policy, as the JAX package's default `prologue_recovery`
    does:
      every-frame keyframing (rejection is a tracking failure): the stale
        frame is rejected too, and so is every later frame of the chunk
        (the state no longer advances);
      motion-gated keyframing (`every_frame_keyframe=False`: rejection is
        routine): the recovery branch matches the frame again against the
        carried last-accepted features (`state.prev_*`) by mutual nearest
        neighbours, with the essential RANSAC on the same draws `u[i]` as
        the prologue's pair. The branch is taken on the host: the
        previous frame's verdict is read back once per frame after the
        first of the chunk, the one wait for the card in this mode.

    With a SubpixHead the extractor refines every detection (see
    build_extract_fn); the rest of the chunk is that of the centroid.

    With a PairSubpixHead (`subpix_head`), the prologue refines each pair's
    matched CURRENT keypoints from both endpoint patches, descriptors and
    the match score between matching and the essential RANSAC, which then
    runs on the refined coordinates; the refined keypoints (descriptors are
    not resampled) and the patches go on into the per-frame loop. The
    state must carry `prev_patches` (init_track_state(patch=...)). The
    refinement needs the batched prologue: `prologue=False` (the JAX
    package's serial layout, not ported) raises."""
    pair_mode = _pair_mode(subpix_head)
    if pair_mode and not prologue:
        raise ValueError("PairSubpixHead requires prologue=True")
    if not prologue:
        raise NotImplementedError(
            "the serial layout (prologue=False) is not ported; see "
            "ROADMAP.md")
    prologue_recovery = not cfg.runtime.every_frame_keyframe
    use_pnp = cfg.runtime.tracker == "pnp"
    g = cfg.geometry
    thr = cfg.frontend.match_threshold
    extract_batch = build_extract_fn(cfg, sp_net, subpix_head=subpix_head)
    lg_match = build_matcher(cfg, lg_net)
    reobs_matcher = lg_match if cfg.frontend.reobs_matcher == "lightglue" \
        else None

    def essential_of(kp0, kp1, m, u):
        """The essential RANSAC of the matches `m` between keypoints kp0
        and kp1 (leading pair dimensions allowed)."""
        pairf = match_ops.score_filter(m.matches0, m.mscores0, thr)
        uv0, uv1, pairf = match_ops.gather_matched(kp0, kp1, m.matches0,
                                                   pairf)
        return essential_mod.estimate_essential(
            K, uv0, uv1, pairf, u, threshold_px=g.essential_threshold_px,
            num_hypotheses=g.essential_hypotheses,
            refine_iters=g.essential_refine_iters)

    def chunk_fn(state: frontend.TrackState, images, frame_idx0: int, u,
                 frame_gate=None, pnp_gumbel=None):
        if not use_pnp and u is None:
            raise ValueError("the essential tracker needs the RANSAC draws "
                             "`u`")
        with record_function("extract"):
            feats = extract_batch(images)
        kpts_b, desc_b, valid_b = feats[:3]
        patches_b = feats[3] if pair_mode else None
        # Pair t = (frame t-1, frame t); pair 0 uses the stored
        # last-accepted features.
        kp0_b = torch.cat([state.prev_kpts[None], kpts_b[:-1]])
        d0_b = torch.cat([state.prev_desc[None], desc_b[:-1]])
        v0_b = torch.cat([state.prev_valid[None], valid_b[:-1]])
        with record_function("prologue.match"):
            m_b = lg_match(kp0_b, d0_b, v0_b, kpts_b, desc_b, valid_b)
        if pair_mode:
            # refine the matched current keypoints; pair t-1's refinement
            # of frame t-1 reaches pair t through kp0_b
            with record_function("prologue.subpix"):
                pat0_b = torch.cat([state.prev_patches[None],
                                    patches_b[:-1]])
                kpts_b = pair_refine_scatter(
                    subpix_head, pat0_b, patches_b, d0_b, desc_b, kpts_b,
                    m_b.matches0, m_b.mscores0,
                    match_ops.score_filter(m_b.matches0, m_b.mscores0, thr))
            kp0_b = torch.cat([state.prev_kpts[None], kpts_b[:-1]])
        ess_b = None
        if not use_pnp:
            with record_function("prologue.essential"):
                ess_b = essential_of(kp0_b, kpts_b, m_b, u)

        outs, recovered = [], []
        ok_prev = torch.ones((), dtype=torch.bool, device=kpts_b.device)
        frame_ids = torch.arange(frame_idx0, frame_idx0 + chunk,
                                 dtype=torch.int32, device=kpts_b.device)
        for i in range(chunk):
            f = frontend.FrameFeatures(
                kpts=kpts_b[i], desc=desc_b[i], valid=valid_b[i],
                frame_idx=frame_ids[i])
            fg = None if frame_gate is None else frame_gate[i]
            if prologue_recovery:
                # pair 0's partner is the carried state itself
                recover = i > 0 and not bool(ok_prev)
                gate = fg
            else:
                recover = False
                gate = ok_prev if fg is None else ok_prev & fg
            if recover:
                with record_function("track.recover"):
                    m = match_ops.mutual_nn_match(
                        state.prev_desc, state.prev_valid, f.desc, f.valid)
                    ess = None if use_pnp else essential_of(
                        state.prev_kpts, f.kpts, m, u[i])
            else:
                m = match_ops.MatchResult(matches0=m_b.matches0[i],
                                          mscores0=m_b.mscores0[i])
                ess = None if ess_b is None else \
                    essential_mod.EssentialResult(*(x[i] for x in ess_b))
            state, out = frontend.track_step_impl(
                cfg, K, state, f, matches=m, ess_result=ess,
                matcher=reobs_matcher, accept_gate=gate,
                patches=None if patches_b is None else patches_b[i],
                pnp_gumbel=None if pnp_gumbel is None else pnp_gumbel[i])
            ok_prev = out.frame_ok if fg is None \
                else torch.where(fg, out.frame_ok, ok_prev)
            outs.append(out)
            recovered.append(recover)
        return state, outs, recovered

    return chunk_fn
