"""EuRoC MAV dataset I/O (ASL layout).

The port's own copy of `gl_slam_tpu/io/euroc.py` (numpy and PIL, no
torch). Layout (e.g. MH_01_easy):

  mav0/cam0/data/<timestamp_ns>.png     grayscale frames
  mav0/cam0/sensor.yaml                 intrinsics + body->sensor extrinsic
  mav0/state_groundtruth_estimate0/data.csv   GT body states

The surface of io/kitti.py: intrinsics K, per-frame world->camera GT (R, t)
with x_cam = R @ x_world + t, lazy frames (the same reader as KITTI's), GT
scale and motion gate. sensor.yaml is read by a parser of the few fields
EuRoC uses, so no YAML package is needed.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from .kitti import gt_motion_small, gt_scale, read_gray


def _parse_sensor_yaml(path: str):
    """Intrinsics K, (height, width) and T_BS from an EuRoC sensor.yaml."""
    with open(path) as f:
        text = f.read()

    def block_list(name):
        m = re.search(name + r":\s*(?:.|\n)*?data:\s*\[([^\]]*)\]", text)
        if m is None:
            return None
        return np.array([float(v) for v in m.group(1).replace("\n", " ")
                         .split(",")])

    def inline_list(name):
        m = re.search(name + r":\s*\[([^\]]*)\]", text)
        if m is None:
            return None
        return np.array([float(v) for v in m.group(1).split(",")])

    intr = inline_list("intrinsics")          # [fu, fv, cu, cv]
    res = inline_list("resolution")           # [width, height]
    tbs = block_list("T_BS")                  # 16 values row-major
    K = np.array([[intr[0], 0.0, intr[2]],
                  [0.0, intr[1], intr[3]],
                  [0.0, 0.0, 1.0]], dtype=np.float64)
    T_BS = tbs.reshape(4, 4) if tbs is not None else np.eye(4)
    width, height = int(res[0]), int(res[1])
    return K, (height, width), T_BS


def _quat_to_R(qw, qx, qy, qz):
    """Hamilton quaternion (w,x,y,z) -> rotation matrix."""
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)]])


class EurocSequence:
    """One EuRoC sequence: intrinsics + time-aligned GT + lazy frames."""

    def __init__(self, root: str, cam: str = "cam0",
                 gt_dir: str = "state_groundtruth_estimate0"):
        mav = os.path.join(root, "mav0")
        self.cam_dir = os.path.join(mav, cam, "data")
        self.K, (self.height, self.width), self.T_BS = _parse_sensor_yaml(
            os.path.join(mav, cam, "sensor.yaml"))
        self.timestamps = sorted(
            int(f[:-4]) for f in os.listdir(self.cam_dir)
            if f.endswith(".png"))
        self.num_frames = len(self.timestamps)

        gt_csv = os.path.join(mav, gt_dir, "data.csv")
        self.gt_R: Optional[np.ndarray] = None
        self.gt_t: Optional[np.ndarray] = None
        if os.path.exists(gt_csv):
            raw = np.loadtxt(gt_csv, delimiter=",", skiprows=1)
            gt_ts = raw[:, 0]
            # Nearest-timestamp GT per camera frame; world->camera pose from
            # T_WC = T_WB (body GT) @ T_BS (body->cam extrinsic), inverted.
            R_list, t_list = [], []
            for ts in self.timestamps:
                i = int(np.argmin(np.abs(gt_ts - ts)))
                T_WB = np.eye(4)
                T_WB[:3, :3] = _quat_to_R(*raw[i, 4:8])
                T_WB[:3, 3] = raw[i, 1:4]
                T_WC = T_WB @ self.T_BS
                R = T_WC[:3, :3].T
                R_list.append(R)
                t_list.append(-R @ T_WC[:3, 3])
            self.gt_R = np.stack(R_list)
            self.gt_t = np.stack(t_list)

    def frame(self, idx: int) -> np.ndarray:
        return read_gray(os.path.join(self.cam_dir,
                                      f"{self.timestamps[idx]}.png"))

    def gt_scale(self, i: int, j: int) -> float:
        return gt_scale(self.gt_R, self.gt_t, i, j)

    def gt_motion_small(self, i: int, j: int, mag_thr: float,
                        rot_thr_deg: float) -> bool:
        """GT motion gate, same semantics as KittiSequence."""
        return gt_motion_small(self.gt_R, self.gt_t, i, j, mag_thr,
                               rot_thr_deg)
