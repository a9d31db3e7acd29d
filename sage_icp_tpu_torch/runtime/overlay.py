"""Camera-overlay writer: paints each scan (label-colored) onto the
matching camera image and saves PNGs — the offline counterpart of the
reference's live image replay publishers
(reference eval/kittiraw_image_pub.py:166-266 and
eval/"kitti360_image_pub copy.py":258-358, which stream /image_raw +
colored clouds for rviz side-by-side inspection).

Projection math lives in utils.visualization (project_to_image /
overlay_scan_on_image); this module adds the file plumbing: image
discovery by frame index, calibration from a KITTI calib dict, and the
every-N-frames write policy, so the CLI can enable it with --image-dir.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from sage_icp_tpu_torch.utils.visualization import overlay_scan_on_image

# KITTI odometry default calibration (sequence 00-02 rig), used when no
# calib dict is supplied: Tr (velodyne -> rectified cam0) and P2. Real
# runs should pass the sequence's calib.txt values via set_calib().
_DEFAULT_TR = np.array(
    [
        [4.276802385584e-04, -9.999672484946e-01, -8.084491683471e-03, -1.198459927713e-02],
        [-7.210626507497e-03, 8.081198471645e-03, -9.999413164504e-01, -5.403984729748e-02],
        [9.999738645903e-01, 4.859485810390e-04, -7.206933692422e-03, -2.921968648686e-01],
        [0.0, 0.0, 0.0, 1.0],
    ]
)
_DEFAULT_P2 = np.array(
    [
        [7.188560000000e+02, 0.0, 6.071928000000e+02, 4.538225000000e+01],
        [0.0, 7.188560000000e+02, 1.852157000000e+02, -1.130887000000e-01],
        [0.0, 0.0, 1.0, 3.779761000000e-03],
    ]
)

_IMG_EXTS = (".png", ".jpg", ".jpeg")


def _read_image(path: str) -> np.ndarray:
    try:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"))
    except ImportError:
        import matplotlib.image as mpimg

        img = mpimg.imread(path)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        img = img[..., :3]
    return np.ascontiguousarray(img, dtype=np.uint8)


def _write_image(path: str, img: np.ndarray) -> None:
    try:
        from PIL import Image

        Image.fromarray(img).save(path)
    except ImportError:
        import matplotlib.image as mpimg

        mpimg.imsave(path, img)


class OverlayWriter:
    """Writes scan-on-image overlay PNGs every `every` frames.

    image_dir is scanned once for frame-indexed images (sorted by name,
    index i -> i-th file — the KITTI convention of 000000.png ...).
    """

    def __init__(
        self,
        image_dir: str,
        out_dir: str,
        every: int = 50,
        T_cam_from_lidar: np.ndarray | None = None,
        P_rect: np.ndarray | None = None,
    ):
        self.files = sorted(
            f
            for f in glob.glob(os.path.join(image_dir, "*"))
            if f.lower().endswith(_IMG_EXTS)
        )
        self.out_dir = out_dir
        self.every = max(1, every)
        self.T = _DEFAULT_TR if T_cam_from_lidar is None else T_cam_from_lidar
        self.P = _DEFAULT_P2 if P_rect is None else P_rect
        self.written: list[str] = []
        os.makedirs(out_dir, exist_ok=True)

    def set_calib(self, calib: dict | None) -> None:
        """Adopt a KITTI calib.txt dict (keys 'Tr', 'P2' as 4x4 rows from
        datasets.kitti.read_calib_file)."""
        if not calib:
            return
        if "Tr" in calib:
            self.T = np.asarray(calib["Tr"])
        if "P2" in calib:
            self.P = np.asarray(calib["P2"])[:3, :4]

    def maybe_write(self, frame_idx: int, scan: np.ndarray) -> str | None:
        if frame_idx % self.every or frame_idx >= len(self.files):
            return None
        img = _read_image(self.files[frame_idx])
        out = overlay_scan_on_image(img, np.asarray(scan), self.T, self.P)
        path = os.path.join(self.out_dir, f"{frame_idx:06d}.png")
        _write_image(path, out)
        self.written.append(path)
        return path
