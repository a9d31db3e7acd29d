"""Which frames of the window failed. bench_torch.py's guards, copied: a
drive fails every frame it handed in when, over that drive,

  * a silent-drop counter of the step (StepAux.overflow_total()'s
    channels) or the dynamic filter's landmark cells dropped is nonzero;
  * the frame or source downsample reached 0.95 of its capacity, or a
    scan is longer than scan_capacity (the configuration is undersized);
  * the trajectory is lost: its RMS position error against the drive's
    ground truth (both from the drive's first frame) is 1 m or more.

The counters are read once a drive, so a drop in one frame fails the
whole drive. Besides, a frame whose pose is not finite fails."""

from __future__ import annotations

import numpy as np

from benchmark.reference.odometry import DROP_COUNTERS

CAPACITY_SHARE = 0.95
MAX_ATE_M = 1.0


def ate(poses: np.ndarray, gt: np.ndarray) -> float:
    g0 = np.linalg.inv(gt[0])
    errs = [np.linalg.norm(e[:3, 3] - (g0 @ g)[:3, 3]) for e, g in zip(poses, gt)]
    return float(np.sqrt(np.mean(np.square(errs))))


def drive_faults(drive, cfg: dict, gt: np.ndarray, longest_scan: int) -> list:
    """Why the drive fails, one line a reason (none: it holds)."""
    t = drive.totals
    out = [f"{f}={int(t[f])}" for f in DROP_COUNTERS if int(t[f])]
    if drive.landmark_cells_dropped:
        out.append(f"landmark_cells_dropped={drive.landmark_cells_dropped}")
    for field, cap in (("num_frame_ds", "frame_capacity"), ("num_source", "source_capacity")):
        if int(t[field]) >= CAPACITY_SHARE * cfg[cap]:
            out.append(f"{field} {int(t[field])} reached {CAPACITY_SHARE} of {cap} {cfg[cap]}")
    if longest_scan > cfg["scan_capacity"]:
        out.append(f"a scan of {longest_scan} points exceeds scan_capacity {cfg['scan_capacity']}")
    err = ate(drive.poses, gt)
    if not err < MAX_ATE_M:
        out.append(f"ATE {err} m over {drive.frames} frames")
    return out


def failed_frames(drives: list, cfg: dict, gt: np.ndarray, longest_scan: int) -> tuple[int, list]:
    """(failed frames, the reasons) over the window's drives."""
    failed, reasons = 0, []
    for i, d in enumerate(drives):
        why = drive_faults(d, cfg, gt, longest_scan)
        if why:
            failed += d.frames
            reasons.append(f"drive {i}: " + "; ".join(why))
        else:
            failed += int(np.sum(~np.isfinite(np.asarray(d.poses)).all(axis=(1, 2))))
    return failed, reasons
