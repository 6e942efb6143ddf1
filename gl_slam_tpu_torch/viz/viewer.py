"""Trajectory / map visualization, out of the tracking loop.

Counterpart of `gl_slam_tpu/viz/viewer.py`: `MapSnapshot` copies the
visualizable part of the port's `MapState` to the host, `to_json` exports
it for an external 3D viewer, `render_topdown` plots the map and
trajectory from above and `render_keypoint_overlay` draws one frame's
keypoints, both to PNG through matplotlib (Agg). The two renderers return
False when matplotlib is missing. `LiveViewer` streams snapshots to
`live.json` (and `live.png` where matplotlib is present) during a run.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Optional

import numpy as np


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class MapSnapshot:
    """Host copy of the keyframe centres, the good map points and the
    covisibility edges of a map state (one device-to-host copy per field
    read, so the snapshot stays valid while tracking goes on)."""

    def __init__(self, map_state, max_points: int = 100000):
        n_kf = int(map_state.num_kf)
        n_pts = int(map_state.num_pts)
        self.kf_R = _host(map_state.kf_R[:n_kf])
        self.kf_t = _host(map_state.kf_t[:n_kf])
        self.centers = -np.einsum('fij,fj->fi',
                                  np.transpose(self.kf_R, (0, 2, 1)),
                                  self.kf_t) if n_kf else np.zeros((0, 3))
        pts = _host(map_state.pts_xyz[:n_pts])
        good = (_host(map_state.pts_valid[:n_pts])
                & ~_host(map_state.pts_bad[:n_pts]))
        self.points = pts[good][:max_points]
        nbr = _host(map_state.covis_nbr[:n_kf])
        self.covis_edges = [(k, int(j)) for k in range(n_kf)
                            for j in nbr[k] if j >= 0]

    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump({
                "keyframe_centers": self.centers.tolist(),
                "points": self.points.tolist(),
                "covisibility_edges": self.covis_edges,
            }, f)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def render_topdown(snapshot: MapSnapshot, path: str,
                   gt_centers: Optional[np.ndarray] = None,
                   follow_center: Optional[np.ndarray] = None,
                   follow_radius_m: Optional[float] = None) -> bool:
    """Top-down (x-z) map + trajectory plot. Returns False if matplotlib is
    unavailable (use to_json then). `follow_center` + `follow_radius_m`
    crop the view to a window around that world point."""
    plt = _pyplot()
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(8, 8))
    if len(snapshot.points):
        ax.scatter(snapshot.points[:, 0], snapshot.points[:, 2], s=0.5,
                   c="tab:blue", alpha=0.4, label="map points")
    for a, b in snapshot.covis_edges:
        if a < len(snapshot.centers) and b < len(snapshot.centers):
            ax.plot([snapshot.centers[a, 0], snapshot.centers[b, 0]],
                    [snapshot.centers[a, 2], snapshot.centers[b, 2]],
                    c="gray", lw=0.3, alpha=0.5)
    if len(snapshot.centers):
        ax.plot(snapshot.centers[:, 0], snapshot.centers[:, 2],
                c="tab:red", lw=1.5, label="estimated")
    if gt_centers is not None:
        ax.plot(gt_centers[:, 0], gt_centers[:, 2], c="tab:green", lw=1.0,
                ls="--", label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    if follow_center is not None and follow_radius_m is not None:
        ax.set_xlim(follow_center[0] - follow_radius_m,
                    follow_center[0] + follow_radius_m)
        ax.set_ylim(follow_center[2] - follow_radius_m,
                    follow_center[2] + follow_radius_m)
    ax.legend(loc="best")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def render_keypoint_overlay(image: np.ndarray, kpts: np.ndarray,
                            valid: np.ndarray, path: str,
                            tracked_mask: Optional[np.ndarray] = None) -> bool:
    """Per-frame overlay: tracked keypoints green, new ones red. Returns
    False if matplotlib is unavailable."""
    plt = _pyplot()
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(image, cmap="gray", vmin=0, vmax=1)
    k = kpts[valid]
    if tracked_mask is not None:
        tm = tracked_mask[valid]
        ax.scatter(k[tm, 0], k[tm, 1], s=6, c="lime", marker="o",
                   linewidths=0, label="tracked")
        ax.scatter(k[~tm, 0], k[~tm, 1], s=6, c="red", marker="o",
                   linewidths=0, label="new")
    else:
        ax.scatter(k[:, 0], k[:, 1], s=6, c="lime", linewidths=0)
    ax.axis("off")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


class LiveViewer:
    """During-run map streaming for a headless machine.

    The tracking loop calls `update(map_state, frame_idx)` once per frame;
    every `every`-th call takes a `MapSnapshot` (the host copy, on the
    caller's thread, so the worker holds no device tensor) and hands it to
    a worker thread, which writes `live.json` and, where matplotlib is
    present, `live.png` (top-down view following the latest keyframe),
    each through a temporary file and an atomic `os.replace`, so a poller
    always reads a complete file. The queue holds ONE pending snapshot: a
    newer one replaces it (dropped frames, as in a real-time viewer), so
    rendering never holds tracking back. `close()` flushes what is pending
    and stops the worker."""

    def __init__(self, out_dir: str, every: int = 8,
                 follow_radius_m: float = 60.0):
        self.out_dir = out_dir
        self.every = max(int(every), 1)
        self.follow_radius_m = follow_radius_m
        self.num_renders = 0
        self.last_frame = None          # frame index of the last render
        self._n_updates = 0
        os.makedirs(out_dir, exist_ok=True)
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._stop = object()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def update(self, map_state, frame_idx: int) -> None:
        """Cheap unless this is an export frame (a device-to-host copy of
        the map's visualizable fields then)."""
        self._n_updates += 1
        if self._n_updates % self.every != 0:
            return
        item = (MapSnapshot(map_state), int(frame_idx))
        try:
            self._q.put_nowait(item)
        except queue.Full:          # drop the stale pending snapshot
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            try:
                self._q.put_nowait(item)
            except queue.Full:
                pass

    def close(self) -> None:
        """Flush the pending snapshot and stop the worker."""
        self._q.put(self._stop)
        self._thread.join(timeout=30)

    def _worker(self):
        while True:
            item = self._q.get()
            if item is self._stop:
                return
            snap, self.last_frame = item
            jtmp = os.path.join(self.out_dir, ".live.json.tmp")
            snap.to_json(jtmp)
            os.replace(jtmp, os.path.join(self.out_dir, "live.json"))
            # matplotlib takes the format from the suffix: the temporary
            # name must end in .png
            ptmp = os.path.join(self.out_dir, ".tmp.live.png")
            center = snap.centers[-1] if len(snap.centers) else None
            if render_topdown(snap, ptmp, follow_center=center,
                              follow_radius_m=self.follow_radius_m):
                os.replace(ptmp, os.path.join(self.out_dir, "live.png"))
            self.num_renders += 1
