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
frames run the whole step but are never accepted. The serial layout
(`prologue=False`) matches each pair in the per-frame loop instead.

The chunk also runs S sequences at once on a leading stream axis
(`build_multistream_chunk_fn`, parallel/multistream.py): extraction in
groups of streams, then one prologue over all S T pairs and a per-frame
loop whose every step covers the S streams.

Spans (tracing.py): `chunk` around a multi-stream chunk, `extract` around
each extraction call, `prologue` around the prologue (`prologue.match`,
`prologue.subpix`, `prologue.essential`) and `track` around the per-frame
loop, whose frames are marked with `tracing.at_frame`; the recovery
branch's read of the previous verdict is the span `track.host_read`.
`chunk`, `prologue` and `track` are recorded without a profiler range
(`tracing.span`'s `profile=False`), so a device trace keeps the ranges it
had: the leaves, and a caller's own range around the call.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import tracing
from ..config import SLAMConfig
from ..geometry import essential as essential_mod
from ..models.lightglue import normalize_keypoints
from ..models.subpix import (PairSubpixHead, SubpixHead, centroid_refine,
                             gather_patches, pair_refine_scatter)
from ..models.superpoint import padded_heatmap, sample_descriptors
from ..ops import assignment as assignment_ops
from ..ops import match as match_ops
from ..ops import nms as nms_ops
from ..parallel import mesh as mesh_lib
from . import frontend
from .state import _where


class FusedParams(NamedTuple):
    """The networks of the chunked pipeline. The JAX package keeps each
    network's parameter tree here and the modules apart; a PyTorch module
    carries its weights, so this holds the modules themselves."""
    sp: Any          # SuperPointNet
    lg: Any          # LightGlueNet
    ks: Any = None   # SubpixHead or PairSubpixHead (None = centroid)


def detector_heatmap(cfg: SLAMConfig, sp_net, images):
    """images (B, H, W) in [0, 1] -> (heat (B, H8, W8) float32 with the
    padding up to multiples of 8 zeroed, descriptor grid)."""
    return padded_heatmap(sp_net, images, cfg.frontend.image_height,
                          cfg.frontend.image_width)


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


def _split_features(feats, pair_mode: bool):
    """(kpts, desc, valid, patches or None) of an extractor's output or of
    the `features=` argument."""
    if pair_mode:
        if len(feats) < 4:
            raise ValueError("a PairSubpixHead needs features=(kpts, desc, "
                             "valid, patches)")
        return tuple(feats[:4])
    return tuple(feats[:3]) + (None,)


def build_chunk_fn(cfg: SLAMConfig, sp_net, lg_net, K, chunk: int,
                   subpix_head=None, prologue: bool = True,
                   prologue_recovery: bool | None = None,
                   match_with_lightglue: bool = True,
                   reobs_with_lightglue: bool | None = None):
    """fn(state, images (T, H, W), frame_idx0, u (T, hypotheses, 8),
    frame_gate=None, pnp_gumbel=None, features=None) -> (state, list of T
    TrackOutputs, list of T bools: the frames whose pass-1 match took the
    recovery branch). `u` holds each pair's RANSAC draws; under the PnP
    tracker no RANSAC runs in the prologue, `u` may be None, and
    `pnp_gumbel` (T, pnp_hypotheses, N) holds each frame's PnP RANSAC
    draws.

    `features=(kpts (T, N, 2), desc, valid[, patches])` replaces the images
    (pass images=None): extraction is skipped, as the multi-stream chunk
    does after extracting in groups of streams (build_multistream_chunk_fn).

    Stream axis: a state with a leading stream axis of S
    (`frontend.init_track_state(..., num_streams=S)`) runs S independent
    sequences through one call. Every per-chunk input then carries the
    axis in front: images (S, T, H, W) (extracted as one batch of S T),
    features (S, T, ...), `u` (S, T, hypotheses, 8), `frame_gate` (S, T)
    and `pnp_gumbel` (S, T, ...); `frame_idx0` is shared. Each
    TrackOutputs field is (S,), and each recovery entry a numpy (S,) bool
    array. The prologue's LightGlue pass and fused assignment cover all S T
    pairs in one call each, and each re-observation pass all S streams, so
    the attention and assignment launches of a chunk do not depend on S.

    `frame_gate` (T,) bool force-rejects the frames where it is False (ANDed
    into the acceptance gate): a driver pads a partial tail chunk with
    copies of its last real frame and gates the copies off. Gated frames
    still run the whole step, matcher passes included. Padding only ever
    trails real frames, so a gated frame leaves the chain of acceptances
    (`ok_prev`) as it was.

    A frame that follows a rejected one finds its precomputed pair stale
    (matched against the rejected frame). `prologue_recovery` decides what
    happens then; None follows the keyframe policy, as in the JAX package:
      False (the default under every-frame keyframing, where rejection is
        a tracking failure): the stale frame is rejected too, and so is
        every later frame of the chunk (the state no longer advances);
      True (the default under motion-gated keyframing,
        `every_frame_keyframe=False`, where rejection is routine): the
        recovery branch matches the frame again against the carried
        last-accepted features (`state.prev_*`) by mutual nearest
        neighbours, with the essential RANSAC on the same draws `u[i]` as
        the prologue's pair. The branch is taken on the host: the previous
        frame's verdict is read back once per frame after the first of the
        chunk, the one wait for the card in this mode. Under a stream axis
        the S verdicts are read at once; when any stream needs the branch
        it runs for all streams on the stream axis and each stream selects
        its own result (JAX's `lax.cond` under `vmap`). The read goes
        through `tracing.host_read` (the span `track.host_read`).

    `match_with_lightglue=False` matches pass 1 by mutual nearest
    neighbours instead of LightGlue. `reobs_with_lightglue` picks the
    matcher of the re-observation passes (None: `cfg.frontend.
    reobs_matcher`).

    `prologue=False` is the serial layout: no prologue, each frame matches
    its pair in the per-frame loop (LightGlue, or without it mutual
    nearest neighbours inside the step) and runs its essential RANSAC
    there on `u[i]`; a frame after a rejected one is matched against the
    carried last-accepted features, so no frame is stale.

    With a SubpixHead the extractor refines every detection (see
    build_extract_fn); the rest of the chunk is that of the centroid.

    With a PairSubpixHead (`subpix_head`), the prologue refines each pair's
    matched CURRENT keypoints from both endpoint patches, descriptors and
    the match score between matching and the essential RANSAC, which then
    runs on the refined coordinates; the refined keypoints (descriptors are
    not resampled) and the patches go on into the per-frame loop. The
    state must carry `prev_patches` (init_track_state(patch=...)). The
    refinement needs the batched prologue: `prologue=False` raises.

    The chunk runs without autograd (`torch.no_grad`): a direct call would
    otherwise keep every matcher layer's activations for a backward pass
    that never comes."""
    pair_mode = _pair_mode(subpix_head)
    if pair_mode and not prologue:
        raise ValueError("PairSubpixHead requires prologue=True")
    if prologue_recovery is None:
        prologue_recovery = not cfg.runtime.every_frame_keyframe
    if reobs_with_lightglue is None:
        reobs_with_lightglue = cfg.frontend.reobs_matcher == "lightglue"
    use_pnp = cfg.runtime.tracker == "pnp"
    g = cfg.geometry
    thr = cfg.frontend.match_threshold
    extract_batch = build_extract_fn(cfg, sp_net, subpix_head=subpix_head)
    lg_match = build_matcher(cfg, lg_net)
    reobs_matcher = lg_match if reobs_with_lightglue else None

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

    def pass1(kp0, d0, v0, kp1, d1, v1):
        if match_with_lightglue:
            return lg_match(kp0, d0, v0, kp1, d1, v1)
        return match_ops.mutual_nn_match(d0, v0, d1, v1)

    @torch.no_grad()
    def chunk_fn(state: frontend.TrackState, images, frame_idx0: int, u,
                 frame_gate=None, pnp_gumbel=None, features=None):
        if not use_pnp and u is None:
            raise ValueError("the essential tracker needs the RANSAC draws "
                             "`u`")
        L = state.map.lead
        lead = state.map.num_kf.shape
        if features is None:
            with tracing.span("extract"):
                flat = images.reshape((-1,) + images.shape[L + 1:])
                feats = tuple(x.reshape(lead + (chunk,) + x.shape[1:])
                              for x in extract_batch(flat))
        else:
            feats = features
        kpts_b, desc_b, valid_b, patches_b = _split_features(feats,
                                                             pair_mode)
        dev = kpts_b.device

        def fr(x, i):
            """Frame i of a per-chunk input (behind the stream axis)."""
            return None if x is None else x.select(L, i)

        def pairs(carried, batch):
            """Pair partners: the carried frame, then frames 0..T-2."""
            return torch.cat([carried.unsqueeze(L),
                              batch.narrow(L, 0, chunk - 1)], dim=L)

        frame_ids = torch.arange(frame_idx0, frame_idx0 + chunk,
                                 dtype=torch.int32, device=dev)
        if not prologue:
            return _serial(state, kpts_b, desc_b, valid_b, frame_ids, u,
                           frame_gate, pnp_gumbel, fr, lead)

        # Pair t = (frame t-1, frame t); pair 0 uses the stored
        # last-accepted features.
        with tracing.span("prologue", profile=False):
            kp0_b = pairs(state.prev_kpts, kpts_b)
            d0_b = pairs(state.prev_desc, desc_b)
            v0_b = pairs(state.prev_valid, valid_b)
            with tracing.span("prologue.match"):
                m_b = pass1(kp0_b, d0_b, v0_b, kpts_b, desc_b, valid_b)
            if pair_mode:
                # refine the matched current keypoints; pair t-1's
                # refinement of frame t-1 reaches pair t through kp0_b
                with tracing.span("prologue.subpix"):
                    pat0_b = pairs(state.prev_patches, patches_b)
                    kpts_b = pair_refine_scatter(
                        subpix_head, pat0_b, patches_b, d0_b, desc_b, kpts_b,
                        m_b.matches0, m_b.mscores0,
                        match_ops.score_filter(m_b.matches0, m_b.mscores0,
                                               thr))
                kp0_b = pairs(state.prev_kpts, kpts_b)
            ess_b = None
            if not use_pnp:
                with tracing.span("prologue.essential"):
                    ess_b = essential_of(kp0_b, kpts_b, m_b, u)
        with tracing.span("track", profile=False):
            outs, recovered = [], []
            ok_prev = torch.ones(lead, dtype=torch.bool, device=dev)
            for i in range(chunk):
                tracing.at_frame(i)
                f = frontend.FrameFeatures(
                    kpts=fr(kpts_b, i), desc=fr(desc_b, i),
                    valid=fr(valid_b, i), frame_idx=frame_ids[i].expand(lead))
                fg = fr(frame_gate, i)
                m = match_ops.MatchResult(*(fr(x, i) for x in m_b))
                ess = None if ess_b is None else \
                    essential_mod.EssentialResult(*(fr(x, i) for x in ess_b))
                if prologue_recovery:
                    # pair 0's partner is the carried state itself
                    stale = np.zeros(lead, dtype=bool) if i == 0 else \
                        ~tracing.host_read(ok_prev, "track.host_read").numpy()
                    gate = fg
                else:
                    stale = np.zeros(lead, dtype=bool)
                    gate = ok_prev if fg is None else ok_prev & fg
                if stale.any():
                    with tracing.span("track.recover"):
                        m_r = match_ops.mutual_nn_match(
                            state.prev_desc, state.prev_valid, f.desc, f.valid)
                        ess_r = None if use_pnp else essential_of(
                            state.prev_kpts, f.kpts, m_r, fr(u, i))
                    if L == 0:
                        m, ess = m_r, ess_r
                    else:
                        sel = torch.from_numpy(stale).to(dev)
                        m = type(m)(*(_where(sel, a, b)
                                      for a, b in zip(m_r, m)))
                        ess = None if ess is None else type(ess)(*(
                            _where(sel, a, b) for a, b in zip(ess_r, ess)))
                state, out = frontend.track_step_impl(
                    cfg, K, state, f, matches=m, ess_result=ess,
                    matcher=reobs_matcher, accept_gate=gate,
                    patches=fr(patches_b, i), pnp_gumbel=fr(pnp_gumbel, i))
                ok_prev = out.frame_ok if fg is None \
                    else torch.where(fg, out.frame_ok, ok_prev)
                outs.append(out)
                recovered.append(bool(stale) if L == 0 else stale)
            return state, outs, recovered

    def _serial(state, kpts_b, desc_b, valid_b, frame_ids, u, frame_gate,
                pnp_gumbel, fr, lead):
        """The serial layout: pass-1 matching and the essential RANSAC in
        the per-frame loop, against the carried last-accepted features."""
        outs = []
        with tracing.span("track", profile=False):
            for i in range(chunk):
                tracing.at_frame(i)
                f = frontend.FrameFeatures(
                    kpts=fr(kpts_b, i), desc=fr(desc_b, i),
                    valid=fr(valid_b, i), frame_idx=frame_ids[i].expand(lead))
                m = None
                if match_with_lightglue:
                    with tracing.span("track.match"):
                        m = lg_match(state.prev_kpts, state.prev_desc,
                                     state.prev_valid, f.kpts, f.desc,
                                     f.valid)
                state, out = frontend.track_step_impl(
                    cfg, K, state, f, matches=m, matcher=reobs_matcher,
                    accept_gate=fr(frame_gate, i),
                    u=None if use_pnp else fr(u, i),
                    pnp_gumbel=fr(pnp_gumbel, i))
                outs.append(out)
        no = False if not lead else np.zeros(lead, dtype=bool)
        return state, outs, [no] * chunk

    return chunk_fn


def build_multistream_chunk_fn(cfg: SLAMConfig, sp_net, lg_net, K,
                               chunk: int, num_streams: int, devices=None,
                               extract_group: int = 1, **kw):
    """S concurrent sequences through the chunk in lock step: the
    counterpart of the JAX package's `build_multistream_chunk_fn`
    (BASELINE configs[4]), with an explicit leading stream axis where JAX
    vmaps.

    fn(states, images (S, T, H, W), frame_idx0, u (S, T, hypotheses, 8),
    frame_gate=None (S, T), pnp_gumbel=None) -> (states, list of T
    TrackOutputs with (S,) fields, list of T (S,) recovery flags). `states`
    is a stream-batched TrackState (frontend.init_track_state(...,
    num_streams=S)); each stream's RANSAC draws are its own rows of `u`.

    Extraction is not one (S T)-image batch: it runs one `extract_batch`
    call per group of `extract_group` streams (g T images; the group falls
    back to 1 when it does not divide S), which bounds the activation
    memory as JAX's `lax.map` over groups does. The features then feed
    `features=` of ONE chunk function on the stream axis, so the attention
    and assignment launches of a chunk equal a single stream's whatever S
    is, and NMS launches S / g times.

    `devices`: a list of devices (parallel/mesh.make_mesh) over which the
    stream axis is split in equal parts, as JAX's `shard_map` over the
    `data` axis. `states` is then the list of per-device parts
    (mesh.shard_streams), the per-stream inputs are split and moved the
    same way, each part runs its own chunk function on its device with no
    operation across parts, and the result is (list of part states, list of
    per-part outputs, list of per-part recovery flags). With one device
    (one H100) the split is the identity.

    K: (3, 3) shared by all streams, or (S, 3, 3), one camera per stream
    (KITTI's sequences come with three calibrations), carried on the
    stream axis into the chunk function and, under `devices`, split with
    it. `kw` goes to build_chunk_fn (subpix_head, prologue,
    prologue_recovery, match_with_lightglue, reobs_with_lightglue)."""
    K = torch.as_tensor(K, dtype=torch.float32)
    if K.dim() == 3 and K.shape[0] != num_streams:
        raise ValueError(f"K of shape {tuple(K.shape)} for {num_streams} "
                         f"streams")
    parts = mesh_lib.stream_parts(num_streams, devices)
    subpix_head = kw.pop("subpix_head", None)
    pair_mode = _pair_mode(subpix_head)
    built = []
    for dev, sl in parts:
        sp_d, lg_d, head_d = (mesh_lib.module_on(x, dev)
                              for x in (sp_net, lg_net, subpix_head))
        k_dev = dev if dev is not None \
            else next(sp_net.parameters()).device
        K_d = K if K.dim() == 2 else K[sl]
        built.append((
            build_extract_fn(cfg, sp_d, subpix_head=head_d),
            build_chunk_fn(cfg, sp_d, lg_d, K_d.to(k_dev), chunk,
                           subpix_head=head_d, **kw)))

    def extract_streams(extract_batch, images):
        """(s, T, H, W) -> features (s, T, ...), one call per group."""
        s = images.shape[0]
        grp = max(1, min(extract_group, s))
        if s % grp:
            grp = 1
        outs = []
        for j in range(0, s, grp):
            with tracing.span("extract"):
                outs.append(extract_batch(images[j:j + grp].reshape(
                    (grp * chunk,) + images.shape[2:])))
        feats = [torch.cat(xs).reshape((s, chunk) + xs[0].shape[1:])
                 for xs in zip(*outs)]
        return _split_features(feats, pair_mode)

    def run_part(p, state, images, frame_idx0, u, frame_gate, pnp_gumbel):
        extract_batch, chunk_fn = built[p]
        feats = extract_streams(extract_batch, images)
        if not pair_mode:
            feats = feats[:3]
        return chunk_fn(state, None, frame_idx0, u, frame_gate=frame_gate,
                        pnp_gumbel=pnp_gumbel, features=feats)

    @torch.no_grad()
    def ms_chunk(states, images, frame_idx0: int, u, frame_gate=None,
                 pnp_gumbel=None):
        if images.shape[0] != num_streams:
            raise ValueError(f"images for {images.shape[0]} streams, built "
                             f"for {num_streams}")
        with tracing.span("chunk", streams=num_streams, step=True,
                          profile=False):
            if devices is None:
                return run_part(0, states, images, frame_idx0, u, frame_gate,
                                pnp_gumbel)
            ins = [mesh_lib.shard_streams(x, devices)
                   for x in (images, u, frame_gate, pnp_gumbel)]
            res = []
            for p in range(len(parts)):
                im, up, fg, gum = (None if x is None else x[p] for x in ins)
                res.append(run_part(p, states[p], im, frame_idx0, up, fg,
                                    gum))
            return tuple(list(r) for r in zip(*res))

    return ms_chunk
