"""KITTI-360 dataset reader, the offline equivalent of the reference's
kitti360 replay publishers (reference eval/kitti360_pub.py,
eval/kitti360_oxts_pub_wogt.py).

  * fixed cam0 -> velodyne extrinsic Tr (kitti360_pub.py:250-253)
  * poses.txt rows are "frame_idx r11 ... t3" keyed by frame index,
    converted to the LiDAR frame via Tr^-1 P Tr (kitti360_pub.py:245-271)
  * OXTS GPS variant: lat/lon/alt + euler -> pose, no GT alignment
    (kitti360_oxts_pub_wogt.py:278-354)
"""

from __future__ import annotations

import glob
import os

import numpy as np

from sage_icp_tpu_torch.datasets.kitti import parse_floats

# cam0 -> velodyne extrinsic used by the reference (kitti360_pub.py:250-253)
TR_CAM_TO_VELO = np.array(
    [
        [0.99992906, 0.0057743, 0.01041756, 0.77104934],
        [0.00580536, -0.99997879, -0.00295331, 0.29854144],
        [0.01040029, 0.00301357, -0.99994137, -0.83628022],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


def read_kitti360_poses(path: str) -> dict[int, np.ndarray]:
    """frame index -> 4x4 LiDAR-frame pose."""
    Tr_inv = np.linalg.inv(TR_CAM_TO_VELO)
    poses = {}
    with open(path) as f:
        for line in f:
            v = parse_floats(line)
            if v.size < 13:
                continue
            P = np.eye(4)
            P[:3, :4] = v[1:13].reshape(3, 4)
            poses[int(v[0])] = Tr_inv @ P @ TR_CAM_TO_VELO
    return poses


def oxts_to_pose(lat, lon, alt, roll, pitch, yaw, scale=None, origin=None):
    """OXTS GPS record -> 4x4 pose via Mercator projection (reference
    eval/kitti360_oxts_pub_wogt.py:278-330)."""
    er = 6378137.0
    if scale is None:
        scale = np.cos(lat * np.pi / 180.0)
    tx = scale * lon * np.pi * er / 180.0
    ty = scale * er * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    t = np.array([tx, ty, alt])
    if origin is not None:
        t = t - origin
    Rx = np.array([[1, 0, 0], [0, np.cos(roll), -np.sin(roll)], [0, np.sin(roll), np.cos(roll)]])
    Ry = np.array([[np.cos(pitch), 0, np.sin(pitch)], [0, 1, 0], [-np.sin(pitch), 0, np.cos(pitch)]])
    Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = t
    return T


class Kitti360Sequence:
    """data_3d_* layout: <root>/<drive>/velodyne_points/data/*.bin plus
    <poses_root>/<drive>/poses.txt. Scans yield (n, 4) [x y z label] with
    label 0 (labels come from an external network in the reference
    system, L5 in SURVEY.md)."""

    def __init__(self, root: str, drive: str, poses_root: str | None = None):
        self.drive = drive
        self.data_path = os.path.join(root, drive)
        vdir = os.path.join(self.data_path, "velodyne_points", "data")
        if not os.path.isdir(vdir):
            vdir = os.path.join(self.data_path, "velodyne")
        self.velo_files = sorted(glob.glob(os.path.join(vdir, "*.bin")))
        self.frame_ids = [int(os.path.splitext(os.path.basename(f))[0]) for f in self.velo_files]
        self.poses = None
        if poses_root is not None:
            pf = os.path.join(poses_root, drive, "poses.txt")
            if os.path.exists(pf):
                self.poses = read_kitti360_poses(pf)

    def __len__(self) -> int:
        return len(self.velo_files)

    def gt_pose(self, i: int) -> np.ndarray | None:
        if self.poses is None:
            return None
        return self.poses.get(self.frame_ids[i])

    def read_scan(self, i: int) -> np.ndarray:
        out = np.fromfile(self.velo_files[i], dtype=np.float32).reshape(-1, 4).copy()
        out[:, 3] = 0.0  # labels from an external segmentation network
        return out
