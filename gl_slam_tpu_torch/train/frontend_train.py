"""Train the learned front-end on rendered synthetic sequences.

Counterpart of gl_slam_tpu/train/frontend_train.py: the same losses, data
and trainers, on the card unless the caller passes device="cpu".

Losses:
  * SuperPoint detector: per-cell 65-way cross-entropy (each 8x8 cell is
    one of its 64 pixels or a dustbin);
  * SuperPoint descriptor: bidirectional InfoNCE between descriptors
    sampled at corresponding ground-truth keypoints of two views;
  * LightGlue: negative log-likelihood of the ground-truth assignment
    under the dual-softmax + matchability head, plus a BCE pushing the
    matchability of unmatched keypoints to 0.

The JAX `vmap`s are a leading batch axis here. Host sampling is the JAX
package's numpy code line for line, so a seed draws the same frame indices
in both packages; device randomness (photometric augmentation, keypoint
jitter) comes from a `torch.Generator` seeded from the trainer's seed: the
same distribution as the JAX draws, not the same bits.

Each trainer stages its frames on the device once (`stage_packs`); a step
uploads only frame indices and reads nothing back, except the loss where
`log_every` prints it. The networks run under `torch.no_grad` where they
are frozen (`_detect_features_staged`, the matcher's descriptor grids).
The optimiser is optax's `chain(clip_by_global_norm(1.0), adam(lr))`
(`ClipAdam`). Trainers take a module, re-initialise it as Flax would from
`seed` (models.init_like_flax; `reinit=False` keeps its weights) and
return it trained, in place.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device, upload
from ..io import synthetic
from ..models import init_like_flax
from ..models.lightglue import normalize_keypoints
from ..models.subpix import _take_rows, centroid_refine, gather_patches
from ..models.superpoint import sample_descriptors
from ..ops import nms as nms_ops

_NEG = -1e9


# --------------------------------------------------------------- SP labels

def cell_labels(kpts: np.ndarray, valid: np.ndarray, height: int,
                width: int, cell: int = 8) -> np.ndarray:
    """(N,2) pixel keypoints -> (Hc,Wc) int32 per-cell class labels.

    Class = (y%cell)*cell + x%cell for the keypoint pixel; cell**2 (dustbin)
    where the cell holds no keypoint. Last keypoint wins a collision."""
    Hc, Wc = height // cell, width // cell
    lab = np.full((Hc, Wc), cell * cell, np.int32)
    for (x, y), v in zip(kpts, valid):
        if not v:
            continue
        xi, yi = int(round(float(x))), int(round(float(y)))
        if 0 <= xi < Wc * cell and 0 <= yi < Hc * cell:
            lab[yi // cell, xi // cell] = (yi % cell) * cell + (xi % cell)
    return lab


class FramePack(NamedTuple):
    """Pre-rendered training frame: image + GT detections + labels."""
    image: np.ndarray       # (H,W) float32
    kpts: np.ndarray        # (N,2)
    valid: np.ndarray       # (N,)
    lids: np.ndarray        # (N,) landmark ids
    labels: np.ndarray      # (Hc,Wc) detector class labels


def render_pack(scene, frame_idx: int, max_keypoints: int) -> FramePack:
    obs = synthetic.observe_frame(scene, frame_idx, max_keypoints)
    img = synthetic.render_frame(scene, frame_idx, max_keypoints)
    lab = cell_labels(obs.keypoints, obs.valid, scene.height, scene.width)
    return FramePack(image=img.astype(np.float32),
                     kpts=obs.keypoints.astype(np.float32),
                     valid=obs.valid, lids=obs.landmark_ids, labels=lab)


def _first_true(eq: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where none), as
    jnp.argmax of a boolean array."""
    return eq.to(torch.int32).argmax(-1)


# --------------------------------------------------------------- SP loss

def pair_nce(da, db, lida, lidb, va, vb, desc_temp: float = 0.07):
    """Bidirectional InfoNCE of a batch of view pairs: da/db (B,N,D)
    descriptors at the GT keypoints, lid (B,N) landmark ids, v (B,N)
    validity -> (B,) losses. Row i's target is the first j of view b with
    lidb[j] == lida[i]."""
    sim = torch.matmul(da, db.transpose(-1, -2)) / desc_temp      # (B,N,N)
    eq = (lida[..., :, None] == lidb[..., None, :]) \
        & (lida >= 0)[..., :, None]
    has = eq.any(-1) & va
    tgt = _first_true(eq)[..., None]
    sim = torch.where(vb[..., None, :], sim, _NEG)
    logp = torch.log_softmax(sim, dim=-1)
    row_l = -torch.where(has, logp.gather(-1, tgt)[..., 0], 0.0)
    logp_t = torch.log_softmax(torch.where(va[..., :, None], sim, _NEG),
                               dim=-2)
    col_l = -torch.where(has, logp_t.gather(-1, tgt)[..., 0], 0.0)
    denom = torch.clamp_min(has.sum(-1), 1)
    return (row_l.sum(-1) + col_l.sum(-1)) / (2.0 * denom)


def superpoint_loss(sp_net, batch, desc_temp: float = 0.07):
    """batch: dict of stacked view pairs (view a / view b) on one device.

    Returns (detector CE over both views + the InfoNCE descriptor loss
    across the pair, {"det": ..., "desc": ...})."""
    img_a, img_b = batch["image_a"], batch["image_b"]
    x = torch.cat([img_a, img_b], 0)[..., None]
    _, grid, logits = sp_net(x, return_logits=True)
    B = img_a.shape[0]

    labels = torch.cat([batch["labels_a"], batch["labels_b"]], 0)
    det_loss = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               labels.reshape(-1).long())

    d_a = sample_descriptors(grid[:B], batch["kpts_a"])          # (B,N,D)
    d_b = sample_descriptors(grid[B:], batch["kpts_b"])
    desc_loss = pair_nce(d_a, d_b, batch["lids_a"], batch["lids_b"],
                         batch["valid_a"], batch["valid_b"],
                         desc_temp).mean()
    return det_loss + desc_loss, {"det": det_loss, "desc": desc_loss}


# --------------------------------------------------------------- LG loss

def lightglue_loss(lg_net, batch, height: int, width: int):
    """NLL of the GT assignment under dual-softmax + matchability, the mean
    over the batch's pairs.

    batch carries per-pair keypoints (pixel), descriptors, validity and
    landmark ids, each with a leading pair axis; unmatched valid keypoints
    supervise matchability -> 0."""
    v0, v1 = batch["valid0"], batch["valid1"]
    l0, l1 = batch["lids0"], batch["lids1"]
    kn0 = normalize_keypoints(batch["kpts0"], height, width)
    kn1 = normalize_keypoints(batch["kpts1"], height, width)
    sim, z0, z1 = lg_net(batch["desc0"], batch["desc1"], kn0, kn1, v0, v1)
    both = v0[..., :, None] & v1[..., None, :]
    simm = torch.where(both, sim, _NEG)
    lp0 = torch.log_softmax(simm, dim=-1)
    lp1 = torch.log_softmax(simm, dim=-2)
    eq = (l0[..., :, None] == l1[..., None, :]) & (l0 >= 0)[..., :, None] \
        & both
    has0 = eq.any(-1)
    tgt = _first_true(eq)
    at = lambda x: x.gather(-1, tgt[..., None])[..., 0]       # x[i, tgt_i]
    pair_ll = at(lp0) + at(lp1) + F.logsigmoid(z0) \
        + F.logsigmoid(z1).gather(-1, tgt)
    n_pos = torch.clamp_min(has0.sum(-1), 1)
    match_loss = -torch.where(has0, pair_ll, 0.0).sum(-1) / n_pos
    un0 = v0 & ~has0
    un1 = v1 & ~eq.any(-2)
    bce = -(torch.where(un0, F.logsigmoid(-z0), 0.0).sum(-1)
            + torch.where(un1, F.logsigmoid(-z1), 0.0).sum(-1)) \
        / torch.clamp_min(un0.sum(-1) + un1.sum(-1), 1)
    return (match_loss + 0.5 * bce).mean()


# --------------------------------------------------------------- optimiser

class ClipAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr)) over
    `params`: the gradients are scaled to the global norm `max_norm` only
    where their norm is above it (as optax computes it, (g / norm) *
    max_norm, with no epsilon), then torch.optim.Adam (betas (0.9, 0.999),
    eps 1e-8) applies optax's adam update. No host read: the clip selects
    on the device."""

    def __init__(self, params, lr: float, max_norm: float = 1.0):
        self.params = list(params)
        self.max_norm = max_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    def clip(self) -> torch.Tensor:
        """Clip the gradients in place; returns their global norm before."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(torch.stack([torch.sum(g * g)
                                       for g in grads]).sum())
        keep = norm < self.max_norm
        div = torch.where(keep, 1.0, norm)
        mul = torch.where(keep, 1.0, torch.full_like(norm, self.max_norm))
        for g in grads:
            g.div_(div).mul_(mul)
        return norm

    def step(self, loss: Optional[torch.Tensor] = None) -> None:
        """Back-propagate `loss` (or take the gradients already set), clip
        and apply one Adam update."""
        if loss is not None:
            self.adam.zero_grad(set_to_none=True)
            loss.backward()
        self.clip()
        self.adam.step()


# --------------------------------------------------------------- data

def _augment(img: np.ndarray, rng) -> np.ndarray:
    """Photometric augmentation: gain/bias jitter + sensor noise. Keypoint
    positions are untouched, so detector labels stay valid."""
    gain = 0.7 + 0.6 * rng.random()
    bias = 0.05 * (rng.random() - 0.5)
    noisy = img * gain + bias + rng.normal(scale=0.02, size=img.shape)
    return np.clip(noisy, 0.0, 1.0).astype(np.float32)


def _pair_batch(packs, rng, batch_size, gap_choices=(1, 2), augment=True,
                scene_of=None):
    """Sample random (frame, frame+gap) index pairs into stacked arrays.

    `scene_of`: optional array mapping pack index -> scene id; pairs are
    only drawn within a scene (packs from several scenes concatenate)."""
    n = len(packs)
    gmax = max(gap_choices)
    while True:
        ia = rng.integers(0, n - gmax, size=batch_size)
        ib = ia + rng.choice(gap_choices, size=batch_size)
        if scene_of is None or all(scene_of[a] == scene_of[b]
                                   for a, b in zip(ia, ib)):
            break
    img = lambda idx: np.stack(
        [_augment(packs[i].image, rng) if augment else packs[i].image
         for i in idx])
    stack = lambda idx, field: np.stack(
        [getattr(packs[i], field) for i in idx])
    return {
        "image_a": img(ia), "image_b": img(ib),
        "kpts_a": stack(ia, "kpts"), "kpts_b": stack(ib, "kpts"),
        "valid_a": stack(ia, "valid"), "valid_b": stack(ib, "valid"),
        "lids_a": stack(ia, "lids"), "lids_b": stack(ib, "lids"),
        "labels_a": stack(ia, "labels"), "labels_b": stack(ib, "labels"),
    }


class DeviceDataset(NamedTuple):
    """Pre-rendered training frames staged on the device once; each step
    then moves only frame indices."""
    images: torch.Tensor    # (F,H,W) f32
    labels: torch.Tensor    # (F,Hc,Wc) i32 detector cell labels
    kpts: torch.Tensor      # (F,N,2) GT keypoints
    valid: torch.Tensor     # (F,N) bool
    lids: torch.Tensor      # (F,N) i32 landmark ids (-1 invalid)
    scene_of: np.ndarray    # HOST (F,) scene id per frame


def stage_packs(scenes, num_frames: int, max_keypoints: int,
                device) -> DeviceDataset:
    packs, scene_of = [], []
    for si, sc in enumerate(scenes):
        packs.extend(render_pack(sc, i, max_keypoints)
                     for i in range(num_frames))
        scene_of.extend([si] * num_frames)
    dev = torch.device(device)
    field = lambda name, dtype: upload(
        np.stack([getattr(p, name) for p in packs]), dtype, dev)
    return DeviceDataset(
        images=field("image", torch.float32),
        labels=field("labels", torch.int32),
        kpts=field("kpts", torch.float32),
        valid=field("valid", torch.bool),
        lids=field("lids", torch.int32),
        scene_of=np.asarray(scene_of))


def _sample_pairs(rng, scene_of, batch_size, gap_choices=(1, 2),
                  age_max=0):
    """(frame, frame+gap) index pairs drawn within a scene (host side).

    With `age_max` > 0 also draws a descriptor-AGE frame `ic = ia - age`
    (age 0 for half the batch, else ~ U[1, age_max], clamped to the scene
    start): the matcher's re-observation inputs carry descriptors stored
    when the map point was last seen, while its position is a fresh
    projection.

    The JAX package draws the ages also at `age_max` 0, where
    `rng.integers(1, 1)` raises; here no age is drawn then (age 0), and
    at `age_max` > 0 the draws are the JAX package's."""
    n = len(scene_of)
    gmax = max(gap_choices)
    while True:
        ia = rng.integers(0, n - gmax, size=batch_size)
        ib = ia + rng.choice(gap_choices, size=batch_size)
        if age_max > 0:
            age = np.where(rng.random(batch_size) < 0.5, 0,
                           rng.integers(1, age_max + 1, size=batch_size))
        else:
            age = np.zeros(batch_size, np.int64)
        ic = np.maximum(ia - age, 0)
        if all(scene_of[a] == scene_of[b] == scene_of[c]
               for a, b, c in zip(ia, ib, ic)):
            if age_max > 0:
                return (ia.astype(np.int32), ib.astype(np.int32),
                        ic.astype(np.int32))
            return ia.astype(np.int32), ib.astype(np.int32)


def _augment_device(imgs: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
    """Device-side photometric augmentation, the distribution of
    `_augment` (gain/bias jitter + sensor noise), batched."""
    B = imgs.shape[0]
    kw = dict(generator=generator, device=imgs.device)
    gain = 0.7 + 0.6 * torch.rand((B, 1, 1), **kw)
    bias = 0.05 * (torch.rand((B, 1, 1), **kw) - 0.5)
    noise = 0.02 * torch.randn(imgs.shape, **kw)
    return torch.clamp(imgs * gain + bias + noise, 0.0, 1.0)


def _indices(idx: np.ndarray, device) -> torch.Tensor:
    return upload(np.asarray(idx, np.int64), torch.int64, device)


def superpoint_batch(ds: DeviceDataset, ia, ib,
                     generator: torch.Generator) -> dict:
    """The SuperPoint batch of frame pairs (ia[i], ib[i]) (device index
    tensors), both views augmented on the device."""
    return {
        "image_a": _augment_device(ds.images[ia], generator),
        "image_b": _augment_device(ds.images[ib], generator),
        "kpts_a": ds.kpts[ia], "kpts_b": ds.kpts[ib],
        "valid_a": ds.valid[ia], "valid_b": ds.valid[ib],
        "lids_a": ds.lids[ia], "lids_b": ds.lids[ib],
        "labels_a": ds.labels[ia], "labels_b": ds.labels[ib],
    }


# --------------------------------------------------------------- trainers

class _Progress:
    """Per-step bookkeeping of a trainer: prints the loss every
    `log_every` steps (the only host read of a step) and, when `stats` is
    a dict, fills it at the end with the host time before the first step
    (`stage_s`), of the first step (`first_step_s`), the mean of the later
    steps (`step_ms`) and the first and last losses. Timing synchronises
    the device after the first and the last step only."""

    def __init__(self, tag, steps, log_every, stats, device, t0):
        self.tag, self.steps, self.log_every = tag, steps, log_every
        self.stats, self.device = stats, device
        self.first = self.last = None
        self.t = [t0]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t.append(time.perf_counter())

    def start(self):
        if self.stats is not None:
            self._sync()

    def step(self, it, loss, aux=None):
        if self.first is None:
            self.first = loss.detach()
            if self.stats is not None:
                self._sync()
        self.last = loss.detach()
        if self.log_every and (it % self.log_every == 0
                               or it == self.steps - 1):
            extra = "" if aux is None else "".join(
                f" {k}={float(v.detach()):.4f}" for k, v in aux.items())
            print(f"{self.tag} step {it}: loss={float(self.last):.4f}{extra}",
                  flush=True)

    def done(self):
        if self.stats is None:
            return
        self._sync()
        t = self.t
        later = self.steps - 1
        self.stats.update(
            steps=self.steps, stage_s=t[1] - t[0],
            first_step_s=t[2] - t[1] if len(t) > 3 else t[-1] - t[1],
            step_ms=(t[3] - t[2]) / later * 1e3 if later else None,
            first_loss=None if self.first is None else float(self.first),
            last_loss=None if self.last is None else float(self.last))


def _scenes(scene):
    # SyntheticScene is itself a NamedTuple: only a plain list counts as
    # several scenes.
    return scene if isinstance(scene, list) else [scene]


def _prepare(module, dev, seed, reinit):
    module.to(dev)
    if reinit:
        init_like_flax(module, torch.Generator().manual_seed(seed))
    return module.train()


def train_superpoint(sp_net, scene, num_frames: int, max_keypoints: int,
                     steps: int = 300, batch_size: int = 4,
                     lr: float = 1e-3, seed: int = 0, log_every: int = 0,
                     device=None, reinit: bool = True,
                     stats: Optional[dict] = None):
    """Train `sp_net` (SuperPointNet) in place on the frames of `scene` (a
    SyntheticScene or a list of them; pairs are drawn within a scene) and
    return it. Frames are rendered and staged on the device once; each
    step uploads the batch's frame indices."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    scenes = _scenes(scene)
    H, W = scenes[0].height, scenes[0].width
    if H % 8 or W % 8:
        raise ValueError("train expects H,W multiples of 8")
    ds = stage_packs(scenes, num_frames, max_keypoints, dev)
    rng = np.random.default_rng(seed)
    _prepare(sp_net, dev, seed, reinit)
    opt = ClipAdam(sp_net.parameters(), lr)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prog = _Progress("sp", steps, log_every, stats, dev, t0)
    prog.start()
    for it in range(steps):
        ia, ib = _sample_pairs(rng, ds.scene_of, batch_size)
        batch = superpoint_batch(ds, _indices(ia, dev), _indices(ib, dev),
                                 gen)
        loss, aux = superpoint_loss(sp_net, batch)
        opt.step(loss)
        prog.step(it, loss, aux)
    prog.done()
    return sp_net


def _detect_features_staged(sp_net, ds: DeviceDataset, N: int, P: int,
                            score_threshold: float, nms_radius: int,
                            offset_range: float, refine_centroid: bool,
                            subpix_patch: int = 7, chunk: int = 8):
    """Per-frame detections of the frozen SuperPoint + GT matches, on the
    device: (patches (F,N,P,P), desc (F,N,D), target (F,N,2), ok (F,N),
    lid (F,N)). `refine_centroid=True` mirrors the inference-time pair
    head's anchoring (centroid refine -> round -> patch); False anchors at
    the integer detection (the single-view head's)."""
    outs = []
    with torch.no_grad():
        for i in range(0, ds.images.shape[0], chunk):
            images = ds.images[i:i + chunk]
            kpts_gt = ds.kpts[i:i + chunk]
            heat, grid = sp_net(images[..., None])
            kp, _, v = nms_ops.detect_keypoints(heat, N, score_threshold,
                                                nms_radius)
            kp_i = kp.to(torch.float32)
            if refine_centroid:
                kp_ref = centroid_refine(images, kp_i, subpix_patch)
                anchor = torch.round(kp_ref)
            else:
                kp_ref = anchor = kp_i
            patches = gather_patches(images, anchor, P)
            desc = sample_descriptors(grid, kp_ref)
            d = torch.linalg.norm(kp_ref[:, :, None, :]
                                  - kpts_gt[:, None, :, :], dim=-1)
            d = torch.where(ds.valid[i:i + chunk, None, :], d, torch.inf)
            dmin, j = d.min(dim=2)
            ok = v & (dmin < 2.0)
            gtj = _take_rows(kpts_gt, j)
            lid = torch.where(ok, torch.gather(ds.lids[i:i + chunk], 1, j),
                              -1)
            tgt = torch.clamp(gtj - anchor, -offset_range, offset_range)
            outs.append((patches, desc, tgt.to(torch.float32), ok, lid))
    return tuple(torch.cat([o[c] for o in outs]) for c in range(5))


def train_subpix(subpix_head, sp_net, scene, num_frames: int,
                 max_keypoints: int, steps: int = 400, batch_size: int = 4,
                 lr: float = 1e-3, seed: int = 2, log_every: int = 0,
                 nms_radius: int = 3, score_threshold: float = 1e-3,
                 device=None, reinit: bool = True,
                 stats: Optional[dict] = None):
    """Train the single-view sub-pixel head (models/subpix.SubpixHead) in
    place: regress the true sub-pixel offset from (image patch around the
    INTEGER detection, sampled descriptor). Supervision pairs each
    detection of the frozen SuperPoint `sp_net` with its nearest
    ground-truth keypoint within 2 px; the L2 loss is masked to matched
    detections."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    scenes = _scenes(scene)
    rng = np.random.default_rng(seed)
    N = max_keypoints
    P = subpix_head.patch
    ds = stage_packs(scenes, num_frames, max_keypoints, dev)
    sp_net.to(dev)
    patches, desc, target, ok, _ = _detect_features_staged(
        sp_net, ds, N, P, score_threshold, nms_radius,
        subpix_head.offset_range, refine_centroid=False)
    F_ = int(ds.images.shape[0])
    D = desc.shape[-1]
    _prepare(subpix_head, dev, seed, reinit)
    opt = ClipAdam(subpix_head.parameters(), lr)
    prog = _Progress("subpix", steps, log_every, stats, dev, t0)
    prog.start()
    for it in range(steps):
        idx = _indices(rng.integers(0, F_, size=batch_size), dev)
        B = idx.shape[0]
        off = subpix_head(patches[idx].reshape(B * N, P, P),
                          desc[idx].reshape(B * N, D))
        err = torch.sum((off - target[idx].reshape(B * N, 2)) ** 2, dim=-1)
        mk = ok[idx].reshape(B * N)
        loss = torch.sum(torch.where(mk, err, 0.0)) \
            / torch.clamp_min(mk.sum(), 1)
        opt.step(loss)
        prog.step(it, loss)
    prog.done()
    return subpix_head


def train_pair_subpix(pair_head, sp_net, scene, num_frames: int,
                      max_keypoints: int, steps: int = 500,
                      batch_size: int = 4, lr: float = 1e-3, seed: int = 3,
                      log_every: int = 0, nms_radius: int = 3,
                      score_threshold: float = 1e-3, subpix_patch: int = 7,
                      device=None, reinit: bool = True,
                      stats: Optional[dict] = None):
    """Train the pair-conditioned sub-pixel head (models/subpix.
    PairSubpixHead) in place: regress the current keypoint's true sub-pixel
    offset from (patch around the matched PREVIOUS detection, patch around
    the current detection, both descriptors, match score). As at inference
    (slam/fused.py's prologue), detections are centroid-refined,
    patches and targets anchor at round(centroid), descriptors are sampled
    at the refined coordinates, and the score input is the descriptor dot
    product clipped to [0, 1]."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    scenes = _scenes(scene)
    rng = np.random.default_rng(seed)
    N = max_keypoints
    P = pair_head.patch
    ds = stage_packs(scenes, num_frames, max_keypoints, dev)
    sp_net.to(dev)
    patches, desc, target, _, lid = _detect_features_staged(
        sp_net, ds, N, P, score_threshold, nms_radius,
        pair_head.offset_range, refine_centroid=True,
        subpix_patch=subpix_patch)
    D = desc.shape[-1]
    # consecutive in-scene frame pairs; GT landmark-id matching happens on
    # the device inside the step
    pa = np.asarray([a for a in range(len(ds.scene_of) - 1)
                     if ds.scene_of[a] == ds.scene_of[a + 1]], np.int32)
    _prepare(pair_head, dev, seed, reinit)
    opt = ClipAdam(pair_head.parameters(), lr)
    prog = _Progress("pair-subpix", steps, log_every, stats, dev, t0)
    prog.start()
    for it in range(steps):
        ia = _indices(rng.choice(pa, size=batch_size), dev)
        ib = ia + 1
        l0, l1 = lid[ia], lid[ib]                        # (B,N)
        eq = (l0[:, :, None] == l1[:, None, :]) & (l0 >= 0)[:, :, None]
        has = eq.any(-1)
        j = _first_true(eq)
        p0, d0 = patches[ia], desc[ia]
        p1 = _take_rows(patches[ib], j)
        d1 = _take_rows(desc[ib], j)
        t1 = _take_rows(target[ib], j)
        score = torch.clamp(torch.sum(d0 * d1, -1), 0.0, 1.0)
        M = ia.shape[0] * N
        off = pair_head(p0.reshape(M, P, P), p1.reshape(M, P, P),
                        d0.reshape(M, D), d1.reshape(M, D),
                        score.reshape(M))
        err = torch.sum((off - t1.reshape(M, 2)) ** 2, dim=-1)
        mk = has.reshape(M)
        loss = torch.sum(torch.where(mk, err, 0.0)) \
            / torch.clamp_min(mk.sum(), 1)
        opt.step(loss)
        prog.step(it, loss)
    prog.done()
    return pair_head


class MatcherData(NamedTuple):
    """The matcher's training data on the device: the frozen SuperPoint's
    descriptor grids of every staged frame and the GT keypoints."""
    grids: torch.Tensor     # (F,Hc,Wc,D) f32
    kpts: torch.Tensor      # (F,N,2)
    valid: torch.Tensor     # (F,N)
    lids: torch.Tensor      # (F,N)
    scene_of: np.ndarray    # HOST (F,)


def stage_matcher_data(sp_net, scenes, num_frames: int, max_keypoints: int,
                       device) -> MatcherData:
    """Stage the frames and compute the descriptor grids once (frozen
    SuperPoint, 8 frames a call to bound the activations)."""
    ds = stage_packs(scenes, num_frames, max_keypoints, device)
    with torch.no_grad():
        grids = torch.cat([sp_net(ds.images[i:i + 8, ..., None])[1]
                           for i in range(0, ds.images.shape[0], 8)])
    return MatcherData(grids, ds.kpts, ds.valid, ds.lids, ds.scene_of)


def lightglue_batch(data: MatcherData, ia, ib, ic, jitter_px: float,
                    desc_age: bool, generator: torch.Generator) -> dict:
    """The matcher's batch of frame pairs (ia[i], ib[i]) (device index
    tensors): descriptors sampled at the jittered GT keypoints. With
    `desc_age`, row j of set 0 keeps its frame-ia position but takes the
    same landmark's descriptor sampled from frame ic's grid at its frame-ic
    detection (the stored descriptor the map's re-observation passes
    carry), matched by landmark id on the device."""
    kw = dict(generator=generator, device=data.kpts.device)
    kp0 = data.kpts[ia] + jitter_px * torch.randn(data.kpts[ia].shape, **kw)
    kp1 = data.kpts[ib] + jitter_px * torch.randn(data.kpts[ib].shape, **kw)
    desc0 = sample_descriptors(data.grids[ia], kp0)
    if desc_age:
        la, lc = data.lids[ia], data.lids[ic]                  # (B,N)
        eq = (la[:, :, None] == lc[:, None, :]) & (la >= 0)[:, :, None]
        hasold = eq.any(-1)
        kpc = _take_rows(data.kpts[ic], _first_true(eq))
        kpc = kpc + jitter_px * torch.randn(kpc.shape, **kw)
        desc_aged = sample_descriptors(data.grids[ic], kpc)
        desc0 = torch.where(hasold[..., None], desc_aged, desc0)
    return {
        "desc0": desc0,
        "desc1": sample_descriptors(data.grids[ib], kp1),
        "kpts0": kp0, "kpts1": kp1,
        "valid0": data.valid[ia], "valid1": data.valid[ib],
        "lids0": data.lids[ia], "lids1": data.lids[ib],
    }


def train_lightglue(lg_net, sp_net, scene, num_frames: int,
                    max_keypoints: int, steps: int = 300,
                    batch_size: int = 2, lr: float = 8e-4, seed: int = 1,
                    jitter_px: float = 0.5, log_every: int = 0,
                    desc_age_max: int = 6, device=None, reinit: bool = True,
                    stats: Optional[dict] = None):
    """Train the matcher `lg_net` (LightGlueNet) in place on descriptors of
    the frozen SuperPoint `sp_net` sampled at ground-truth keypoints (+
    `jitter_px` Gaussian jitter), so it learns the descriptor distribution
    it sees at inference.

    `desc_age_max` > 0 enables descriptor-age augmentation (set 0 takes
    each landmark's descriptor from its detection `age` frames earlier,
    age 0 for half the pairs, else ~ U[1, desc_age_max]): the input the
    map re-observation passes build. Without it the matcher's recall on
    stale descriptors collapses within a few frames of staleness."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    scenes = _scenes(scene)
    sp_net.to(dev)
    data = stage_matcher_data(sp_net, scenes, num_frames, max_keypoints, dev)
    rng = np.random.default_rng(seed)
    H, W = scenes[0].height, scenes[0].width
    _prepare(lg_net, dev, seed, reinit)
    opt = ClipAdam(lg_net.parameters(), lr)
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    prog = _Progress("lg", steps, log_every, stats, dev, t0)
    prog.start()
    for it in range(steps):
        if desc_age_max > 0:
            ia, ib, ic = _sample_pairs(rng, data.scene_of, batch_size,
                                       age_max=desc_age_max)
        else:
            ia, ib = _sample_pairs(rng, data.scene_of, batch_size)
            ic = ia
        batch = lightglue_batch(data, _indices(ia, dev), _indices(ib, dev),
                                _indices(ic, dev), jitter_px,
                                desc_age_max > 0, gen)
        loss = lightglue_loss(lg_net, batch, H, W)
        opt.step(loss)
        prog.step(it, loss)
    prog.done()
    return lg_net
