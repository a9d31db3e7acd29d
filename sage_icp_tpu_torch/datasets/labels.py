"""Offline label-directory adapter: consume MODEL-PRODUCED per-scan
semantic labels from any segmentation network.

The reference's flagship mode runs on network-predicted labels — the
odometry node subscribes to `/sem_points` published by a Cylinder3D or
RangeNet++ ROS node (reference README.md:30-31,
ros/launch/sem_odom.launch.py:16-28); only the `_gt` variant consumes
dataset ground-truth labels. This framework replaces that live topic with
an offline directory of per-scan label files produced by ANY model:

    labels_dir/
        000000.label   # semantic-KITTI format: int32, class = v & 0xFFFF
        000001.npy     # or any integer numpy array, one entry per point
        ...

Files pair with scans by SORTED ORDER (the same convention every KITTI
eval tool uses for velodyne/*.bin vs labels/*.label). Both formats may be
mixed. Length mismatches are clipped/padded with label 0 (unknown) and
counted, so a desynced directory is observable instead of silently
corrupting the semantic policy.
"""

from __future__ import annotations

import glob
import os

import numpy as np

_EXTS = (".label", ".npy")


def read_label_file(path: str) -> np.ndarray:
    """(n,) int32 class ids. .label = semantic-KITTI packed int32 (lower
    16 bits class, upper 16 instance — reference eval/kitti_pub.py:148-159
    applies the same `& 0xFFFF`); .npy = any integer array."""
    if path.endswith(".label"):
        raw = np.fromfile(path, dtype=np.int32)
        return (raw & 0xFFFF).astype(np.int32)
    if path.endswith(".npy"):
        arr = np.load(path)
        return np.asarray(arr, dtype=np.int32).reshape(-1)
    raise ValueError(f"unsupported label file: {path} (want .label/.npy)")


class LabelDirectory:
    """Per-scan label lookup over a directory of .label/.npy files."""

    def __init__(self, path: str):
        self.path = path
        files = []
        for e in _EXTS:
            files.extend(glob.glob(os.path.join(path, f"*{e}")))
        # sort by basename stem so 000010.npy interleaves with .label
        self.files = sorted(files, key=lambda f: os.path.basename(f))
        if not self.files:
            raise FileNotFoundError(
                f"no .label/.npy files under {path!r}"
            )
        self.mismatched_frames = 0  # frames whose length != scan length

    def __len__(self) -> int:
        return len(self.files)

    def get(self, i: int, n_points: int) -> np.ndarray:
        """(n_points,) float32 labels for scan i; clip/pad-0 on length
        mismatch (counted in mismatched_frames)."""
        if i >= len(self.files):
            self.mismatched_frames += 1
            return np.zeros((n_points,), np.float32)
        lab = read_label_file(self.files[i])
        if len(lab) != n_points:
            self.mismatched_frames += 1
        out = np.zeros((n_points,), np.float32)
        m = min(len(lab), n_points)
        out[:m] = lab[:m]
        return out

    def apply(self, i: int, scan: np.ndarray) -> np.ndarray:
        """Replace the label lane of an (n, >=4) scan with scan i's file
        labels (the offline analog of subscribing to /sem_points instead
        of /label_points)."""
        out = np.array(scan, copy=True)
        out[:, 3] = self.get(i, len(scan))
        return out

    def wrap(self, scans):
        """Wrap a scan iterable so every yielded scan carries this
        directory's labels."""
        for i, s in enumerate(scans):
            yield self.apply(i, s)
