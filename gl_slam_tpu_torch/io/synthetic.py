"""Synthetic scene / sequence generation for tests and benchmarks.

The port's own copy of `gl_slam_tpu/io/synthetic.py` (numpy only).

The reference itself validates SLAM logic by synthesizing keypoint inputs
("synthetic SuperPoint" results built from projected map points,
`/root/reference/src/core/slam_core.cpp:514-525`) — this module generalizes
that trick into a deterministic oracle front-end: a random 3D landmark cloud,
a smooth camera trajectory, and per-frame projected keypoints with descriptor
identities, so the full tracking/BA stack is testable without model weights
(SURVEY.md §4 implication (e)).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticScene(NamedTuple):
    K: np.ndarray            # (3,3) intrinsics
    landmarks: np.ndarray    # (P,3) world points
    descriptors: np.ndarray  # (P,D) unit-norm landmark descriptors
    poses_R: np.ndarray      # (F,3,3) world->camera
    poses_t: np.ndarray      # (F,3)
    height: int
    width: int


class FrameObservation(NamedTuple):
    """Fixed-shape per-frame oracle 'detection' result."""
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
               motion: str = "forward_turn",
               min_depth: float = 2.0,
               loop_period: int | None = None) -> SyntheticScene:
    """Random landmark cloud + smooth forward/turning trajectory.

    Landmarks are scattered in a corridor ahead of the trajectory, mimicking
    KITTI's forward-driving geometry (depth 4..80 m)."""
    rng = np.random.default_rng(seed)
    K = kitti_like_intrinsics(height, width)

    # Trajectory: camera centers along a gentle arc, looking +z
    speed = 1.0
    ts = np.arange(num_frames, dtype=np.float64)
    if motion in ("forward_turn", "forward_turn_band"):
        yaw = 0.004 * ts ** 1.5 / max(num_frames, 1)
    elif motion == "loop":
        # Constant yaw rate closing a full circle over `loop_period` frames
        # (default: the whole sequence): the heading cumsum below then
        # traces a circle of radius speed*period/(2*pi). With
        # num_frames > loop_period the tail RE-TRAVERSES the first lap's
        # path — genuine loop-closure geometry (KITTI 00 re-drives the same
        # road): the camera passes within a frame-step of old keyframes
        # with matching heading, the regime the gap-1/2-trained matcher
        # actually covers (scripts/diag_loop_framepair.py: GT-match
        # agreement 1112 at gap 1 vs 0-3 at 15-20 m separation).
        period = loop_period if loop_period is not None else num_frames
        yaw = 2.0 * np.pi * ts / max(period, 1)
    else:
        yaw = np.zeros_like(ts)
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

    if motion == "loop":
        # Landmarks scattered in a band around the whole circular path, so
        # the same landmarks are visible on the first pass AND the revisit
        fl = rng.integers(0, num_frames, num_landmarks)
        off = np.stack([rng.uniform(-25.0, 25.0, num_landmarks),
                        rng.uniform(-5.0, 10.0, num_landmarks),
                        rng.uniform(-25.0, 25.0, num_landmarks)], axis=1)
        landmarks = centers[fl] + off
    elif motion == "forward_turn_band":
        # Trajectory-anchored band (long sequences): the straight corridor
        # below is axis-aligned, so a curving trajectory drifts OUT of the
        # feature band after a few hundred metres (matching starved from
        # ~frame 600 of the round-3 soak). Anchoring the scatter to the
        # path keeps KITTI-roadside-like density however far it curves.
        fl = rng.integers(0, num_frames, num_landmarks)
        off = np.stack([rng.uniform(-30.0, 30.0, num_landmarks),
                        rng.uniform(-5.0, 10.0, num_landmarks),
                        rng.uniform(0.0, 60.0, num_landmarks)], axis=1)
        landmarks = centers[fl] + off
    else:
        # Landmarks in a corridor ahead of the whole trajectory
        span = centers[-1] - centers[0]
        length = np.linalg.norm(span) + 40.0
        zs = rng.uniform(min_depth, length + 40.0, num_landmarks)
        xs = rng.uniform(-30.0, 30.0, num_landmarks)
        ys = rng.uniform(-5.0, 10.0, num_landmarks)
        landmarks = np.stack([xs, ys, zs], axis=1)

    desc = rng.normal(size=(num_landmarks, desc_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)

    return SyntheticScene(K=K, landmarks=landmarks.astype(np.float64),
                          descriptors=desc,
                          poses_R=poses_R, poses_t=poses_t,
                          height=height, width=width)


def observe_frame(scene: SyntheticScene, frame_idx: int,
                  max_keypoints: int = 512, noise_px: float = 0.0,
                  seed: int = 0) -> FrameObservation:
    """Project landmarks into a frame -> fixed-shape oracle detection."""
    rng = np.random.default_rng(hash((seed, frame_idx)) % (2 ** 31))
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
        & (uv[:, 1] >= 1) & (uv[:, 1] < scene.height - 1) & (z < 120.0)
    ids = np.nonzero(visible)[0]
    # Prefer nearer landmarks when over budget (deterministic)
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

    kps[:n] = uv[ids] + rng.normal(scale=noise_px, size=(n, 2))
    descs[:n] = scene.descriptors[ids]
    scores[:n] = 1.0
    lids[:n] = ids
    valid[:n] = True
    return FrameObservation(keypoints=kps, descriptors=descs, scores=scores,
                            landmark_ids=lids, valid=valid)


def match_by_landmark_id(obs0: FrameObservation, obs1: FrameObservation):
    """Oracle matcher: correspondences by shared landmark id.

    Returns matches0 (N,) int32 index into obs1 (-1 = none), matching the
    reference's LightGlue output convention (`src/core/lightglue.cpp:204-294`,
    matches0 with -1 sentinel)."""
    n = len(obs0.landmark_ids)
    lut = {int(l): j for j, l in enumerate(obs1.landmark_ids) if l >= 0}
    matches0 = np.full((n,), -1, dtype=np.int32)
    for i, l in enumerate(obs0.landmark_ids):
        if l >= 0 and int(l) in lut:
            matches0[i] = lut[int(l)]
    return matches0


def render_frame(scene: SyntheticScene, frame_idx: int,
                 max_keypoints: int = 512,
                 domain: str = "clean") -> np.ndarray:
    """Render a crude grayscale image with per-landmark distinctive blobs.

    Each landmark gets a deterministic anisotropy/orientation/satellite
    signature from its id (discriminative patch descriptors across frames),
    drawn at its CONTINUOUS sub-pixel projection with the intensity peak at
    the true keypoint: the main lobe is a centered anisotropic Gaussian and
    the satellite lobes come in a symmetric +/- pair, so detector training
    labels, centroid refinement, and the GT keypoint all agree to sub-pixel.

    `domain="hard"` adds the photometric nuisance classes real imagery
    carries and the clean blob world lacks (VERDICT r3 missing #3):
      * REPETITIVE STRUCTURE: 25% of landmarks draw their appearance from a
        shared pool of 48 signatures (aliased appearance across distinct
        landmarks — the matcher can no longer rely on appearance alone);
      * ILLUMINATION DRIFT: a slowly varying global gain/offset over the
        sequence (~±30% brightness);
      * OCCLUDERS: 3 dark rectangles sweeping deterministically through the
        frame, erasing whatever features they cover;
      * SENSOR NOISE: per-frame Gaussian pixel noise (sigma 0.02) plus a
        low-frequency horizontal vignette.
    """
    obs = observe_frame(scene, frame_idx, max_keypoints)
    img = np.zeros((scene.height, scene.width), dtype=np.float32)
    hard = domain == "hard"
    R = 5
    yy, xx = np.mgrid[0:2 * R + 1, 0:2 * R + 1].astype(np.float32) - R
    for k in range(len(obs.valid)):
        if not obs.valid[k]:
            continue
        lid = int(obs.landmark_ids[k])
        if hard and lid % 4 == 0:
            lid = lid % 48          # repetitive structure: shared signature
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
        fx, fy = u - iu, v - iv            # sub-pixel center offset
        ct, st = np.cos(th), np.sin(th)
        xs = xx - fx
        ys = yy - fy
        xr = ct * xs + st * ys
        yr = -st * xs + ct * ys
        blob = amp * np.exp(-(xr ** 2 / sx ** 2 + yr ** 2 / sy ** 2))
        # Symmetric satellite pair: distinctive but peak-preserving
        ox, oy = 1.5 + 1.5 * r.random(), (r.random() * 4 - 2)
        for sgn in (1.0, -1.0):
            blob += 0.3 * amp * np.exp(
                -(((xs - sgn * ox) ** 2 + (ys - sgn * oy) ** 2) / 1.2))
        img[iv - R:iv + R + 1, iu - R:iu + R + 1] = np.maximum(
            img[iv - R:iv + R + 1, iu - R:iu + R + 1], blob)
    if hard:
        H_, W_ = scene.height, scene.width
        # Illumination drift + horizontal vignette
        gain = 1.0 + 0.3 * np.sin(frame_idx / 23.0)
        offset = 0.05 * np.sin(frame_idx / 41.0 + 1.0)
        vign = 1.0 - 0.15 * np.cos(
            np.linspace(0, 2 * np.pi, W_, dtype=np.float32)
            + frame_idx / 60.0)[None, :]
        img = img * gain * vign + offset
        # Sweeping occluders (deterministic per frame)
        ro = np.random.default_rng(900 + frame_idx)
        for j in range(3):
            ow = int(W_ * (0.06 + 0.04 * ((frame_idx + 37 * j) % 5) / 4))
            oh = int(H_ * 0.35)
            ox = int(((frame_idx * (13 + 7 * j)) % (W_ + ow)) - ow / 2)
            oy = int((H_ - oh) * ro.random())
            x0, x1 = max(ox, 0), min(ox + ow, W_)
            if x1 > x0:
                img[oy:oy + oh, x0:x1] = 0.02
        # Sensor noise
        img = img + ro.normal(scale=0.02, size=img.shape)
    return np.clip(img, 0.0, 1.0).astype(np.float32)
