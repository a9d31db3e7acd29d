"""KITTI Odometry / SemanticKITTI dataset reader, the offline equivalent
of the reference's ROS2 replay publisher (reference eval/kitti_pub.py).

  * velodyne/*.bin: float32 (n, 4) [x y z intensity] (kitti_pub.py:176)
  * labels/*.label: int32, semantic id = raw & 0xFFFF (kitti_pub.py:153)
  * times.txt with 0.0 -> 0.0001 substitution (kitti_pub.py:118-120)
  * calib.txt "Tr" row; GT poses converted cam -> LiDAR frame via
    Tr^-1 @ P @ Tr (kitti_pub.py:289-312)
  * HDL-64 intrinsic correction: rotate each point 0.205 deg about
    axis = normalize(p x z_hat) (kitti_pub.py:55-84), in float64 numpy

Scans are read and corrected in numpy; there is no native loader.
"""

from __future__ import annotations

import glob
import os

import numpy as np

VERTICAL_CORRECTION_DEG = 0.205


def parse_floats(text: str) -> np.ndarray:
    """Whitespace-separated numbers -> float64 array."""
    return np.array(text.split(), dtype=np.float64)


def correct_kitti_scan(xyz: np.ndarray) -> np.ndarray:
    """HDL-64 calibration correction (reference eval/kitti_pub.py:55-84):
    rotate every point by 0.205 deg around the axis perpendicular to the
    point direction and global z. Returns float32."""
    z = np.array([0.0, 0.0, 1.0], dtype=np.float64)
    axes = np.cross(xyz, z)
    norms = np.linalg.norm(axes, axis=1, keepdims=True)
    norms = np.where(norms < 1e-12, 1.0, norms)
    axes = axes / norms
    theta = VERTICAL_CORRECTION_DEG * np.pi / 180.0
    c, s = np.cos(theta), np.sin(theta)
    # Rodrigues per point: p' = c p + s (a x p) + (1-c) a (a . p)
    a_dot_p = np.sum(axes * xyz, axis=1, keepdims=True)
    out = c * xyz + s * np.cross(axes, xyz) + (1 - c) * axes * a_dot_p
    return out.astype(np.float32)


def azimuth_timestamps(xyz: np.ndarray) -> np.ndarray:
    """Per-point sweep phase in [0, 1] from the azimuth, for motion
    compensation when the sensor gives no time field (KITTI .bin files
    carry none; the HDL-64 spins clockwise). The reference's deskew reads
    timestamps normalized to [0, 1] (ros/ros2/Utils.hpp:55-102)."""
    az = -np.arctan2(xyz[:, 1], xyz[:, 0])
    return (az + np.pi) / (2.0 * np.pi)


def read_calib_file(path: str) -> dict:
    calib = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            v = parse_floats(vals)
            if v.size == 12:
                pose = np.eye(4)
                pose[:3, :4] = v.reshape(3, 4)
                calib[key.strip()] = pose
    return calib


def read_poses_file(path: str, calib: dict) -> np.ndarray:
    """GT poses (camera frame) -> LiDAR frame via Tr^-1 P Tr
    (reference kitti_pub.py:289-312)."""
    Tr = calib["Tr"]
    Tr_inv = np.linalg.inv(Tr)
    poses = []
    with open(path) as f:
        for line in f:
            v = parse_floats(line)
            if v.size != 12:
                continue
            P = np.eye(4)
            P[:3, :4] = v.reshape(3, 4)
            poses.append(Tr_inv @ P @ Tr)
    return np.stack(poses)


def read_timestamps(path: str) -> np.ndarray:
    ts = []
    with open(path) as f:
        for line in f:
            t = float(line)
            if t == 0.0:
                t = 0.0001  # reference kitti_pub.py:119-120
            ts.append(t)
    return np.asarray(ts)


def read_bin_scan(velo_file: str, label_file: str | None, correct: bool) -> np.ndarray:
    """One (n, 4) [x y z label] float32 scan from a velodyne .bin and an
    optional .label file (label 0 without one)."""
    raw = np.fromfile(velo_file, dtype=np.float32).reshape(-1, 4)
    xyz = raw[:, :3]
    if correct:
        xyz = correct_kitti_scan(xyz.astype(np.float64))
    if label_file is not None:
        lab = np.fromfile(label_file, dtype=np.int32)
        lab = (lab & 0xFFFF).astype(np.float32)  # kitti_pub.py:153
        n = min(len(lab), len(xyz))
        return np.concatenate([xyz[:n], lab[:n, None]], axis=1, dtype=np.float32)
    return np.concatenate([xyz, np.zeros((len(xyz), 1), dtype=np.float32)], axis=1)


class KittiOdometrySequence:
    """One KITTI odometry sequence: scans, labels, timestamps, GT poses.

    Layout: <root>/sequences/<seq>/{velodyne, labels, times.txt, calib.txt,
    <seq>.txt or poses.txt}. Iteration yields (n, 4) arrays [x y z label]
    ready for SageICP.register_frame.
    """

    def __init__(self, root: str, sequence: int | str, with_labels: bool = True,
                 apply_scan_correction: bool = True):
        self.seq = f"{int(sequence):02d}" if not isinstance(sequence, str) else sequence
        self.data_path = os.path.join(root, "sequences", self.seq)
        self.velo_files = sorted(glob.glob(os.path.join(self.data_path, "velodyne", "*.bin")))
        self.label_files = (
            sorted(glob.glob(os.path.join(self.data_path, "labels", "*.label"))) if with_labels else []
        )
        self.with_labels = with_labels and len(self.label_files) > 0
        self.apply_scan_correction = apply_scan_correction
        times_file = os.path.join(self.data_path, "times.txt")
        self.timestamps = read_timestamps(times_file) if os.path.exists(times_file) else None
        calib_file = os.path.join(self.data_path, "calib.txt")
        self.calib = read_calib_file(calib_file) if os.path.exists(calib_file) else None
        self.gt_poses = None
        for cand in (
            os.path.join(self.data_path, f"{self.seq}.txt"),
            os.path.join(self.data_path, "poses.txt"),
            os.path.join(root, "poses", f"{self.seq}.txt"),
        ):
            if os.path.exists(cand) and self.calib is not None:
                self.gt_poses = read_poses_file(cand, self.calib)
                break

    def __len__(self) -> int:
        return len(self.velo_files)

    def read_scan(self, i: int) -> np.ndarray:
        return read_bin_scan(self.velo_files[i], self.label_files[i] if self.with_labels else None,
                             self.apply_scan_correction)

    def __iter__(self):
        for i in range(len(self)):
            yield self.read_scan(i)
