"""Keyframe extraction by occupancy-grid overlap — parity with the
reference's ROS-node keyframe path (reference ros/ros2/OdometryServer.cpp:
222-244 and ros/ros2/Utils.hpp:220-258).

A frame becomes a keyframe when the binary 128x128 birds-eye occupancy
grid of the current scan (transformed into the last keyframe's frame)
overlaps the last keyframe's grid by less than `overlap_threshold`.
"""

from __future__ import annotations

import numpy as np

DEFAULT_BOUNDS = ((-51.2, 51.2), (-51.2, 51.2), (-4.0, 2.4))
DEFAULT_OCC_SIZE = (128, 128)  # (H, W)


def points_to_grid(
    points: np.ndarray,
    bounds=DEFAULT_BOUNDS,
    occ_size=DEFAULT_OCC_SIZE,
) -> np.ndarray:
    """Binary occupancy grid (reference Utils.hpp:220-242, including its
    offset convention occ = (p + upper_bound) / resolution)."""
    h, w = occ_size
    (x0, x1), (y0, y1), (z0, z1) = bounds
    x_res = (x1 - x0) / w
    y_res = (y1 - y0) / h
    p = points[:, :3]
    inb = (
        (p[:, 0] >= x0)
        & (p[:, 0] <= x1)
        & (p[:, 1] >= y0)
        & (p[:, 1] <= y1)
        & (p[:, 2] >= z0)
        & (p[:, 2] <= z1)
    )
    q = p[inb]
    ox = ((q[:, 0] + x1) / x_res).astype(int)
    oy = ((q[:, 1] + y1) / y_res).astype(int)
    ok = (ox >= 0) & (ox < w) & (oy >= 0) & (oy < h)
    grid = np.zeros((h, w), dtype=np.int8)
    grid[oy[ok], ox[ok]] = 1
    return grid


def occ_overlap(occ_s: np.ndarray, occ_t: np.ndarray) -> float:
    """|intersection| / |reference| (reference Utils.hpp:244-258)."""
    total = int(occ_s.sum())
    if total == 0:
        return 0.0
    return float(np.logical_and(occ_s == 1, occ_t == 1).sum()) / total


class KeyframeExtractor:
    """Stateful keyframe selector (reference OdometryServer.cpp:222-244)."""

    def __init__(
        self,
        overlap_threshold: float = 0.5,
        bounds=DEFAULT_BOUNDS,
        occ_size=DEFAULT_OCC_SIZE,
    ):
        self.overlap_threshold = overlap_threshold
        self.bounds = bounds
        self.occ_size = occ_size
        self.last_kf_pose: np.ndarray | None = None
        self.last_kf_grid: np.ndarray | None = None
        self.keyframe_indices: list[int] = []
        self._frame_no = -1

    def update(self, points_sensor: np.ndarray, pose: np.ndarray) -> bool:
        """points in the sensor frame + the frame's world pose.
        Returns True iff this frame became a keyframe."""
        self._frame_no += 1
        if self.last_kf_pose is None:
            self.last_kf_pose = pose.copy()
            self.last_kf_grid = points_to_grid(
                points_sensor, self.bounds, self.occ_size
            )
            self.keyframe_indices.append(self._frame_no)
            return True
        # transform current points into the last keyframe's frame
        # (reference sageICP::TransformToLastFrame, pipeline/sageICP.cpp:123)
        rel = np.linalg.inv(self.last_kf_pose) @ pose
        pts = points_sensor[:, :3] @ rel[:3, :3].T + rel[:3, 3]
        grid = points_to_grid(
            np.concatenate([pts, points_sensor[:, 3:4]], axis=1),
            self.bounds,
            self.occ_size,
        )
        if occ_overlap(grid, self.last_kf_grid) < self.overlap_threshold:
            self.last_kf_pose = pose.copy()
            self.last_kf_grid = points_to_grid(
                points_sensor, self.bounds, self.occ_size
            )
            self.keyframe_indices.append(self._frame_no)
            return True
        return False
