"""KITTI odometry dataset I/O and a prefetched frame feed.

The port's own copy of `gl_slam_tpu/io/kitti.py` (numpy and PIL, no
torch): `load_camera_matrix` (calib.txt P0 -> 3x3 K), `load_poses`
(camera-to-world 3x4 rows -> world-to-camera R, t), the `%06d.png`
grayscale frame naming, `KittiSequence`, `write_kitti_sequence` (a rendered
scene in the KITTI layout) and `FramePrefetcher` (a bounded background
decode queue). Frames are decoded and encoded with PIL, as in the JAX
package.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Tuple

import numpy as np


def load_camera_matrix(calib_path: str, camera: str = "P0") -> np.ndarray:
    """Parse a KITTI calib.txt: the P0 3x4 projection -> 3x3 K."""
    with open(calib_path) as f:
        for line in f:
            if line.startswith(camera + ":"):
                vals = np.array([float(v) for v in line.split()[1:]],
                                dtype=np.float64)
                return vals.reshape(3, 4)[:, :3].copy()
    raise ValueError(f"{camera} not found in {calib_path}")


def load_poses(poses_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI GT poses (camera-to-world 3x4 rows) -> world-to-camera
    (R (F,3,3), t (F,3)), x_cam = R @ x_world + t."""
    rows = np.loadtxt(poses_path).reshape(-1, 3, 4)
    R = np.transpose(rows[:, :, :3], (0, 2, 1))
    t = -np.einsum('fij,fj->fi', R, rows[:, :, 3])
    return R, t


def frame_path(seq_dir: str, idx: int, camera_dir: str = "image_0") -> str:
    return os.path.join(seq_dir, camera_dir, f"{idx:06d}.png")


def read_gray(path: str) -> np.ndarray:
    """One image file as grayscale float32 in [0, 1]."""
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("L"), dtype=np.float32) / 255.0


def load_frame(seq_dir: str, idx: int,
               camera_dir: str = "image_0") -> np.ndarray:
    """Load one grayscale frame as float32 [0,1]."""
    return read_gray(frame_path(seq_dir, idx, camera_dir))


def gt_scale(gt_R, gt_t, i: int, j: int) -> float:
    """|GT camera-centre motion| between frames i and j (1.0 without GT)."""
    if gt_R is None:
        return 1.0
    ci = -gt_R[i].T @ gt_t[i]
    cj = -gt_R[j].T @ gt_t[j]
    return float(np.linalg.norm(cj - ci))


def gt_motion_small(gt_R, gt_t, i: int, j: int, mag_thr: float,
                    rot_thr_deg: float) -> bool:
    """GT motion gate: True if the GT motion between frames i and j is
    below both thresholds (the frame should be skipped)."""
    if gt_R is None:
        return False
    dR = gt_R[j] @ gt_R[i].T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    return gt_scale(gt_R, gt_t, i, j) < mag_thr and ang < rot_thr_deg


class KittiSequence:
    """One KITTI odometry sequence: calib + GT poses + lazy frames."""

    def __init__(self, root: str, sequence: str = "00",
                 camera_dir: str = "image_0"):
        self.seq_dir = os.path.join(root, "sequences", sequence)
        self.camera_dir = camera_dir
        self.K = load_camera_matrix(os.path.join(self.seq_dir, "calib.txt"))
        poses_path = os.path.join(root, "poses", f"{sequence}.txt")
        if os.path.exists(poses_path):
            self.gt_R, self.gt_t = load_poses(poses_path)
        else:
            self.gt_R = self.gt_t = None
        img_dir = os.path.join(self.seq_dir, camera_dir)
        self.num_frames = len([f for f in os.listdir(img_dir)
                               if f.endswith(".png")])

    def frame(self, idx: int) -> np.ndarray:
        return load_frame(self.seq_dir, idx, self.camera_dir)

    def gt_scale(self, i: int, j: int) -> float:
        """The monocular scale injected at the bootstrap."""
        return gt_scale(self.gt_R, self.gt_t, i, j)

    def gt_motion_small(self, i: int, j: int, mag_thr: float,
                        rot_thr_deg: float) -> bool:
        return gt_motion_small(self.gt_R, self.gt_t, i, j, mag_thr,
                               rot_thr_deg)


def write_kitti_sequence(root: str, scene, num_frames: int,
                         sequence: str = "00",
                         max_keypoints: int = 512) -> str:
    """Render a synthetic scene into a KITTI-odometry directory layout:
    ``sequences/<seq>/calib.txt`` with a P0 row,
    ``sequences/<seq>/image_0/%06d.png`` 8-bit grayscale frames and
    ``poses/<seq>.txt`` camera-to-world 3x4 GT rows. The text and the
    pixels are those of the JAX package's writer. Returns the root."""
    from PIL import Image

    from . import synthetic

    seq_dir = os.path.join(root, "sequences", sequence)
    img_dir = os.path.join(seq_dir, "image_0")
    poses_dir = os.path.join(root, "poses")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(poses_dir, exist_ok=True)

    K = scene.K
    p0 = [K[0, 0], 0.0, K[0, 2], 0.0,
          0.0, K[1, 1], K[1, 2], 0.0,
          0.0, 0.0, 1.0, 0.0]
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write("P0: " + " ".join(f"{v:.12e}" for v in p0) + "\n")

    with open(os.path.join(poses_dir, f"{sequence}.txt"), "w") as f:
        for i in range(num_frames):
            Rcw = scene.poses_R[i].T                     # camera-to-world
            c = -scene.poses_R[i].T @ scene.poses_t[i]   # camera centre
            row = np.concatenate([Rcw, c[:, None]], axis=1).reshape(-1)
            f.write(" ".join(f"{v:.12e}" for v in row) + "\n")

    for i in range(num_frames):
        img = synthetic.render_frame(scene, i, max_keypoints=max_keypoints)
        arr = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
        Image.fromarray(arr, mode="L").save(
            os.path.join(img_dir, f"{i:06d}.png"))
    return root


class FramePrefetcher:
    """Bounded background decode queue: `loader(i)` runs on a daemon thread
    up to `depth` frames ahead of the consumer. An exception in the loader
    ends the feed and is raised to the consumer, which would otherwise wait
    for a frame that never comes."""

    def __init__(self, loader, indices, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._indices = list(indices)
        self._loader = loader
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for i in self._indices:
                self._q.put((i, self._loader(i)))
        except Exception as e:          # handed to the consumer
            self._q.put(e)
            return
        self._q.put(None)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
