"""KITTI raw-drive dataset reader, the offline equivalent of the
reference's raw replay publisher (reference eval/kittiraw_pub.py).

  * velodyne_points/data/*.bin float32 (n, 4), HDL-64 scan correction
    applied to xyz (kittiraw_pub.py:48-52,81-84; datasets.kitti)
  * ground truth = OXTS T_w_imu normalized by the first frame's inverse
    (kittiraw_pub.py:101-104); T_w_imu from the Mercator projection of
    lat/lon/alt + roll/pitch/yaw with scale = cos(lat0) (pykitti
    semantics, eval/kitti360_oxts_pub_wogt.py:278-330)
  * label 0 unless a labels directory is supplied (the reference takes
    labels from an external segmentation network)

Drive layout: <root>/<date>/<date>_drive_<drive>_sync/
    velodyne_points/data/*.bin, oxts/data/*.txt.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from sage_icp_tpu_torch.datasets.kitti import parse_floats, read_bin_scan
from sage_icp_tpu_torch.datasets.kitti360 import oxts_to_pose


def read_oxts_record(path: str) -> np.ndarray:
    with open(path) as f:
        return parse_floats(f.read())


def oxts_poses(oxts_files: list[str]) -> np.ndarray:
    """T_w_imu per frame: Mercator scale fixed by the first record's
    latitude (the pykitti convention of the reference's `kitti.oxts`)."""
    poses = []
    scale = None
    origin = None
    for f in oxts_files:
        lat, lon, alt, roll, pitch, yaw = read_oxts_record(f)[:6]
        if scale is None:
            scale = np.cos(lat * np.pi / 180.0)
        T = oxts_to_pose(lat, lon, alt, roll, pitch, yaw, scale=scale)
        if origin is None:
            origin = T[:3, 3].copy()
        T[:3, 3] -= origin
        poses.append(T)
    return np.stack(poses) if poses else np.zeros((0, 4, 4))


class KittiRawSequence:
    """One raw drive. Iteration yields (n, 4) [x y z label] scans; gt_poses
    are IMU-frame poses re-based to the first frame (kittiraw_pub.py:101-104)."""

    def __init__(self, root: str, date: str, drive: str, apply_scan_correction: bool = True,
                 labels_dir: str | None = None):
        self.data_path = os.path.join(root, date, f"{date}_drive_{drive}_sync")
        self.velo_files = sorted(glob.glob(os.path.join(self.data_path, "velodyne_points", "data", "*.bin")))
        self.oxts_files = sorted(glob.glob(os.path.join(self.data_path, "oxts", "data", "*.txt")))
        self.apply_scan_correction = apply_scan_correction
        self.label_files = sorted(glob.glob(os.path.join(labels_dir, "*.label"))) if labels_dir else []
        gt = oxts_poses(self.oxts_files)
        self.gt_poses = np.linalg.inv(gt[0])[None] @ gt if len(gt) else None

    def __len__(self) -> int:
        return len(self.velo_files)

    def read_scan(self, i: int) -> np.ndarray:
        label = self.label_files[i] if i < len(self.label_files) else None
        return read_bin_scan(self.velo_files[i], label, self.apply_scan_correction)

    def __iter__(self):
        for i in range(len(self)):
            yield self.read_scan(i)


def discover_drives(root: str) -> list[tuple[str, str]]:
    """All (date, drive) pairs under a raw-KITTI root, sorted by drive
    number (the layout the reference walks, kittiraw_pub.py:243-260)."""
    out = []
    for date in sorted(os.listdir(root)):
        if not date.startswith("2011"):
            continue
        ddir = os.path.join(root, date)
        if not os.path.isdir(ddir):
            continue
        for d in sorted(os.listdir(ddir)):
            if os.path.isdir(os.path.join(ddir, d)) and "_drive_" in d:
                out.append((date, d.split("_drive_")[1].replace("_sync", "")))
    out.sort(key=lambda p: int(p[1]))
    return out
