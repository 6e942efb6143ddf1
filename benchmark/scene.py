"""The drives: a rendered circular road, made from the seed.

Frozen copies of the port's `io/synthetic.py` (`kitti_like_intrinsics`,
`make_scene`'s closed circle, `observe_frame`, `render_frame`, clean
domain only), kept here so that the yardstick does not move when the
program does, and a vectorised renderer in PyTorch that draws the same
images on the card.

`render_frame` composites each visible landmark's blob into the image by
an element-wise maximum, which does not depend on the order of the blobs;
so the vectorised renderer computes every blob of a batch of frames at
once and scatters them with `amax`. The per-landmark blob parameters are
the six draws of `np.random.default_rng(landmark id)` that the loop makes,
taken once per landmark and kept in a file (they depend on the landmark
count alone).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

BLOB_R = 5                    # blob half-size (px), as render_frame
MAX_DEPTH = 120.0             # observe_frame's visibility limit (m)


class SyntheticScene(NamedTuple):
    K: np.ndarray            # (3,3) intrinsics
    landmarks: np.ndarray    # (P,3) world points
    descriptors: np.ndarray  # (P,D) unit-norm landmark descriptors
    poses_R: np.ndarray      # (F,3,3) world->camera
    poses_t: np.ndarray      # (F,3)
    height: int
    width: int


class FrameObservation(NamedTuple):
    keypoints: np.ndarray     # (N,2) pixel coords (padded with 0)
    descriptors: np.ndarray   # (N,D)
    scores: np.ndarray        # (N,)
    landmark_ids: np.ndarray  # (N,) index into scene.landmarks, -1 = pad
    valid: np.ndarray         # (N,) bool


def kitti_like_intrinsics(height: int = 376, width: int = 1241) -> np.ndarray:
    f = 0.58 * width
    return np.array([[f, 0.0, width / 2.0],
                     [0.0, f, height / 2.0],
                     [0.0, 0.0, 1.0]], dtype=np.float32)


def make_scene(num_landmarks: int = 4000, num_frames: int = 40,
               height: int = 376, width: int = 1241,
               desc_dim: int = 64, seed: int = 0,
               loop_period: int | None = None) -> SyntheticScene:
    """Random landmark cloud + the closed circle (frozen copy of the
    `motion="loop"` branch)."""
    rng = np.random.default_rng(seed)
    K = kitti_like_intrinsics(height, width)

    speed = 1.0
    ts = np.arange(num_frames, dtype=np.float64)
    period = loop_period if loop_period is not None else num_frames
    yaw = 2.0 * np.pi * ts / max(period, 1)
    heading = np.cumsum(np.stack([np.sin(yaw), np.zeros_like(yaw),
                                  np.cos(yaw)], axis=1) * speed, axis=0)
    centers = np.concatenate([np.zeros((1, 3)), heading[:-1]], axis=0)
    centers += rng.normal(scale=0.002, size=centers.shape)  # tiny jitter

    poses_R = np.zeros((num_frames, 3, 3), dtype=np.float64)
    poses_t = np.zeros((num_frames, 3), dtype=np.float64)
    for i in range(num_frames):
        c, s = np.cos(yaw[i]), np.sin(yaw[i])
        Rwc = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        R = Rwc.T                      # world->camera
        poses_R[i] = R
        poses_t[i] = -R @ centers[i]

    fl = rng.integers(0, num_frames, num_landmarks)
    off = np.stack([rng.uniform(-25.0, 25.0, num_landmarks),
                    rng.uniform(-5.0, 10.0, num_landmarks),
                    rng.uniform(-25.0, 25.0, num_landmarks)], axis=1)
    landmarks = centers[fl] + off

    desc = rng.normal(size=(num_landmarks, desc_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)

    return SyntheticScene(K=K, landmarks=landmarks.astype(np.float64),
                          descriptors=desc,
                          poses_R=poses_R, poses_t=poses_t,
                          height=height, width=width)


def observe_frame(scene: SyntheticScene, frame_idx: int,
                  max_keypoints: int = 512) -> FrameObservation:
    """Project landmarks into a frame -> fixed-shape detection (frozen
    copy, without pixel noise)."""
    R = scene.poses_R[frame_idx]
    t = scene.poses_t[frame_idx]
    pc = scene.landmarks @ R.T + t
    z = pc[:, 2]
    front = z > 0.5
    uv = np.zeros((len(z), 2))
    uv[front] = (pc[front, :2] / z[front, None])
    uv[front, 0] = scene.K[0, 0] * uv[front, 0] + scene.K[0, 2]
    uv[front, 1] = scene.K[1, 1] * uv[front, 1] + scene.K[1, 2]
    visible = front & (uv[:, 0] >= 1) & (uv[:, 0] < scene.width - 1) \
        & (uv[:, 1] >= 1) & (uv[:, 1] < scene.height - 1) & (z < MAX_DEPTH)
    ids = np.nonzero(visible)[0]
    if len(ids) > max_keypoints:
        order = np.argsort(z[ids])
        ids = ids[order[:max_keypoints]]
    n = len(ids)

    D = scene.descriptors.shape[1]
    kps = np.zeros((max_keypoints, 2), dtype=np.float32)
    descs = np.zeros((max_keypoints, D), dtype=np.float32)
    scores = np.zeros((max_keypoints,), dtype=np.float32)
    lids = np.full((max_keypoints,), -1, dtype=np.int32)
    valid = np.zeros((max_keypoints,), dtype=bool)
    kps[:n] = uv[ids]
    descs[:n] = scene.descriptors[ids]
    scores[:n] = 1.0
    lids[:n] = ids
    valid[:n] = True
    return FrameObservation(keypoints=kps, descriptors=descs, scores=scores,
                            landmark_ids=lids, valid=valid)


def render_frame(scene: SyntheticScene, frame_idx: int,
                 max_keypoints: int = 512) -> np.ndarray:
    """A grayscale image with one distinctive blob per visible landmark,
    drawn at its sub-pixel projection (frozen copy, clean domain)."""
    obs = observe_frame(scene, frame_idx, max_keypoints)
    img = np.zeros((scene.height, scene.width), dtype=np.float32)
    R = BLOB_R
    yy, xx = np.mgrid[0:2 * R + 1, 0:2 * R + 1].astype(np.float32) - R
    for k in range(len(obs.valid)):
        if not obs.valid[k]:
            continue
        lid = int(obs.landmark_ids[k])
        r = np.random.default_rng(lid)
        amp = 0.45 + 0.55 * r.random()
        sx = 1.0 + 1.6 * r.random()
        sy = 1.0 + 1.6 * r.random()
        th = r.random() * np.pi
        u, v = float(obs.keypoints[k, 0]), float(obs.keypoints[k, 1])
        iu, iv = int(round(u)), int(round(v))
        if not (R <= iu < scene.width - R - 1
                and R <= iv < scene.height - R - 1):
            continue
        fx, fy = u - iu, v - iv
        ct, st = np.cos(th), np.sin(th)
        xs = xx - fx
        ys = yy - fy
        xr = ct * xs + st * ys
        yr = -st * xs + ct * ys
        blob = amp * np.exp(-(xr ** 2 / sx ** 2 + yr ** 2 / sy ** 2))
        ox, oy = 1.5 + 1.5 * r.random(), (r.random() * 4 - 2)
        for sgn in (1.0, -1.0):
            blob += 0.3 * amp * np.exp(
                -(((xs - sgn * ox) ** 2 + (ys - sgn * oy) ** 2) / 1.2))
        img[iv - R:iv + R + 1, iu - R:iu + R + 1] = np.maximum(
            img[iv - R:iv + R + 1, iu - R:iu + R + 1], blob)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# The drive and its vectorised renderer

def loop_scene(seed: int, loop_period: int, landmarks_per_frame: int,
               height: int, width: int) -> SyntheticScene:
    """One lap of the closed circle (`motion="loop"`), `landmarks_per_frame`
    landmarks a frame of the lap. Descriptors are not used by the renderer,
    so they are drawn one-dimensional (the landmarks and poses do not
    depend on their width)."""
    return make_scene(num_landmarks=landmarks_per_frame * loop_period,
                      num_frames=loop_period, height=height, width=width,
                      desc_dim=1, seed=seed, loop_period=loop_period)


def blob_params(num_landmarks: int) -> np.ndarray:
    """(P, 6) float64: amp, sx, sy, th, ox, oy of each landmark's blob,
    from the draws of np.random.default_rng(landmark id) in render_frame's
    order."""
    out = np.empty((num_landmarks, 6), np.float64)
    for lid in range(num_landmarks):
        out[lid] = np.random.default_rng(lid).random(6)
    amp = 0.45 + 0.55 * out[:, 0]
    sx = 1.0 + 1.6 * out[:, 1]
    sy = 1.0 + 1.6 * out[:, 2]
    th = out[:, 3] * np.pi
    ox = 1.5 + 1.5 * out[:, 4]
    oy = out[:, 5] * 4 - 2
    return np.stack([amp, sx, sy, th, ox, oy], axis=1)


def blob_params_cached(num_landmarks: int, cache_dir: str) -> np.ndarray:
    """`blob_params(num_landmarks)`, read from `cache_dir` where an earlier
    run left it, else computed and written there."""
    path = os.path.join(cache_dir, f"blobs_{num_landmarks}.npy")
    try:
        out = np.load(path)
        if out.shape == (num_landmarks, 6):
            return out
    except (OSError, ValueError):
        pass
    out = blob_params(num_landmarks)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.save(f, out)
    os.replace(tmp, path)
    return out


def render_frames_torch(scene: SyntheticScene, frame_ids, max_keypoints: int,
                        device, params=None, batch: int = 24):
    """`render_frame` of each frame in `frame_ids`, computed on `device`:
    (F, H, W) float32. Projection and blob arithmetic run in float64 (the
    loop mixes float32 and float64; the images agree to float32 rounding).
    `params`: blob_params of the scene's landmarks (computed if None)."""
    import torch
    f64 = torch.float64
    H, W = scene.height, scene.width
    if params is None:
        params = blob_params(len(scene.landmarks))
    L = torch.as_tensor(scene.landmarks, dtype=f64, device=device)
    prm = torch.as_tensor(params, dtype=f64, device=device)
    K = torch.as_tensor(scene.K.astype(np.float64), device=device)
    R_all = torch.as_tensor(scene.poses_R, dtype=f64, device=device)
    t_all = torch.as_tensor(scene.poses_t, dtype=f64, device=device)
    ids = torch.as_tensor(np.asarray(frame_ids, np.int64), device=device)
    R = BLOB_R
    ar = torch.arange(-R, R + 1, dtype=f64, device=device)
    yy, xx = ar[:, None].expand(2 * R + 1, 2 * R + 1), \
        ar[None, :].expand(2 * R + 1, 2 * R + 1)
    out = torch.empty((len(frame_ids), H, W), dtype=torch.float32,
                      device=device)
    for b0 in range(0, len(frame_ids), batch):
        fid = ids[b0:b0 + batch]
        B = fid.numel()
        pc = torch.einsum("pj,bij->bpi", L, R_all[fid]) + t_all[fid][:, None]
        z = pc[..., 2]
        front = z > 0.5
        zs = torch.where(front, z, torch.ones_like(z))
        u = torch.where(front, K[0, 0] * (pc[..., 0] / zs) + K[0, 2], 0.0)
        v = torch.where(front, K[1, 1] * (pc[..., 1] / zs) + K[1, 2], 0.0)
        vis = front & (u >= 1) & (u < W - 1) & (v >= 1) & (v < H - 1) \
            & (z < MAX_DEPTH)
        # the nearest max_keypoints visible landmarks of each frame
        key = torch.where(vis, z, torch.full_like(z, float("inf")))
        k = min(max_keypoints, key.shape[1])
        zk, lid = torch.topk(key, k, dim=1, largest=False, sorted=False)
        ok = torch.isfinite(zk)
        # keypoints are stored as float32 (observe_frame's kps array)
        uk = torch.gather(u, 1, lid).float().to(f64)
        vk = torch.gather(v, 1, lid).float().to(f64)
        iu, iv = torch.round(uk), torch.round(vk)
        ok &= (iu >= R) & (iu < W - R - 1) & (iv >= R) & (iv < H - R - 1)
        amp, sx, sy, th, ox, oy = prm[lid].unbind(-1)          # (B, k)
        xs = xx - (uk - iu)[..., None, None]                    # (B,k,P,P)
        ys = yy - (vk - iv)[..., None, None]
        ct, st = torch.cos(th)[..., None, None], torch.sin(th)[..., None, None]
        xr = ct * xs + st * ys
        yr = -st * xs + ct * ys
        a = amp[..., None, None]
        blob = a * torch.exp(-(xr ** 2 / sx[..., None, None] ** 2
                               + yr ** 2 / sy[..., None, None] ** 2))
        for sgn in (1.0, -1.0):
            blob = blob + 0.3 * a * torch.exp(
                -(((xs - sgn * ox[..., None, None]) ** 2
                   + (ys - sgn * oy[..., None, None]) ** 2) / 1.2))
        blob = blob.float()
        py = (iv.long()[..., None, None] + yy.long())
        px = (iu.long()[..., None, None] + xx.long())
        frame = torch.arange(B, device=device)[:, None, None, None]
        flat = (frame * (H * W) + py.clamp(0, H - 1) * W
                + px.clamp(0, W - 1))
        okb = ok[..., None, None].expand_as(blob)
        img = torch.zeros(B * H * W, dtype=torch.float32, device=device)
        img.scatter_reduce_(0, flat[okb], blob[okb], reduce="amax")
        out[b0:b0 + B] = img.view(B, H, W).clamp_(0.0, 1.0)
    return out
