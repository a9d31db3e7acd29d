"""Colored point-cloud dumps — the offline counterpart of the reference's
colored frame / local-map publishers (reference ros/ros2/OdometryServer.cpp:
211-220 + the color LUT packing at ros/launch/odometry.launch.py:69-81).

Writes binary little-endian PLY, viewable in CloudCompare/Meshlab/Open3D.
"""

from __future__ import annotations

import numpy as np

from sage_icp_tpu_torch.utils.labels import COLOR_MAP_BGR


def label_colors_rgb_u8(labels: np.ndarray) -> np.ndarray:
    lut = np.zeros((260, 3), dtype=np.uint8)
    for k, (b, g, r) in COLOR_MAP_BGR.items():
        lut[k] = (r, g, b)
    return lut[np.clip(labels.astype(int), 0, 259)]


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """points: (n, >=3); colors: (n, 3) uint8 or None (then colored by the
    semantic label in lane 3 when present, grey otherwise)."""
    n = len(points)
    if colors is None:
        if points.shape[1] >= 4:
            colors = label_colors_rgb_u8(points[:, 3])
        else:
            colors = np.full((n, 3), 180, dtype=np.uint8)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.zeros(
        n,
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
               ("r", "u1"), ("g", "u1"), ("b", "u1")],
    )
    rec["x"], rec["y"], rec["z"] = (points[:, i].astype(np.float32) for i in range(3))
    rec["r"], rec["g"], rec["b"] = colors[:, 0], colors[:, 1], colors[:, 2]
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def dump_local_map(path: str, odom) -> int:
    """Write the current semantic local map (colored by label)."""
    pts = odom.local_map()
    write_ply(path, pts)
    return len(pts)


def project_to_image(
    points: np.ndarray,
    T_cam_from_lidar: np.ndarray,
    P_rect: np.ndarray,
    image_shape: tuple,
) -> tuple[np.ndarray, np.ndarray]:
    """Project a (n, >=3) LiDAR scan into a rectified camera.

    T_cam_from_lidar: (4, 4) extrinsic (KITTI: R_rect @ Tr_velo_to_cam);
    P_rect: (3, 4) projection (KITTI P2); image_shape: (h, w).
    Returns (uv (n, 2) float pixel coords, mask (n,) in-front + in-bounds).
    Offline counterpart of the reference's camera replay publishers
    (eval/kittiraw_image_pub.py, eval/kitti360_image_pub copy.py), which
    stream /image_raw for rviz side-by-side inspection.
    """
    n = len(points)
    xyz1 = np.concatenate(
        [points[:, :3], np.ones((n, 1), points.dtype)], axis=1
    )
    cam = xyz1 @ T_cam_from_lidar.T  # (n, 4)
    z = cam[:, 2]
    pix = cam @ P_rect.T  # (n, 3)
    uv = pix[:, :2] / np.maximum(pix[:, 2:3], 1e-9)
    h, w = image_shape[:2]
    mask = (z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (
        uv[:, 1] >= 0
    ) & (uv[:, 1] < h)
    return uv, mask


def overlay_scan_on_image(
    image: np.ndarray,
    points: np.ndarray,
    T_cam_from_lidar: np.ndarray,
    P_rect: np.ndarray,
    radius: int = 1,
) -> np.ndarray:
    """Paint label-colored scan points onto an (h, w, 3) uint8 image copy."""
    out = image.copy()
    uv, mask = project_to_image(points, T_cam_from_lidar, P_rect, image.shape)
    colors = (
        label_colors_rgb_u8(points[:, 3])
        if points.shape[1] >= 4
        else np.full((len(points), 3), 255, np.uint8)
    )
    u = uv[mask, 0].astype(int)
    v = uv[mask, 1].astype(int)
    c = colors[mask]
    h, w = image.shape[:2]
    for du in range(-radius, radius + 1):
        for dv in range(-radius, radius + 1):
            uu = np.clip(u + du, 0, w - 1)
            vv = np.clip(v + dv, 0, h - 1)
            out[vv, uu] = c
    return out
