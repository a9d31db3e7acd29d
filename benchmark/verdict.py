"""What decides `correct`: the program's outputs of the window against the
plain reference's, worked out again from the same scans.

The reference follows the program's trajectory of the checked drive one
step at a time (reference.odometry.Reference.register with
`follow`): for each frame it starts from the state that the program's
poses of the earlier frames built, works out the frame's pose itself, and
moves on with the program's pose. So each frame's pose is judged as one
step, and the map after the drive holds every frame at the program's
pose. A free-running comparison would judge the drive's chaos instead:
in the drive's first frames, before the vehicle has moved 0.5 m, the
correspondence gate is 6 m wide, the ICP takes 15-50 iterations down a
flat valley, and the order in which the GN sums are added moves where it
stops by up to 1.4 cm, which the two maps then carry for the rest of the
drive.

The numbers (a cell compares those its limits/<cell>.json names):

    pose_gap_m              the largest distance between a frame's
                            position and the reference's one-step
                            position, over every frame of every run of
                            the checked drive
    rotation_gap_rad        the largest angle between a frame's
                            orientation and the reference's one-step one
    map_point_mismatch      the share of the local map's points after the
                            window's last frame that the reference's map
                            does not hold: the same voxel, the same block
                            lane, the same label, each coordinate within
                            MATCH_TOLERANCE_M (the insert, the retention
                            policy and the cull)
    vehicle_point_mismatch  the same over the points with a vehicle-class
                            label: what the dynamic filter left in
    counter_gap             the summed difference of the silent-drop
                            counters and the landmark cells dropped, drive
                            by drive (exact: its limit is 0)

A number is within its limit when it is at most the limit; a number
that is NaN never is."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.odometry import DROP_COUNTERS
from benchmark.reference.voxel_map import QSCALE

MATCH_TOLERANCE_M = 1e-3


def pose_gaps(drives_poses: list, ref_poses: list) -> tuple:
    """Each frame's position gap (m) and rotation gap (rad) against the
    reference's pose of the same frame index, every drive's frames in one
    array each; NaN where a pose is not finite."""
    ref = np.asarray(ref_poses, dtype=np.float64)
    dt, dr = [], []
    for poses in drives_poses:
        p = np.asarray(poses, dtype=np.float64).reshape(-1, 4, 4)
        r = ref[: len(p)]
        dt.append(np.linalg.norm(p[:, :3, 3] - r[:, :3, 3], axis=1))
        # |R1 - R2|_F = 2 sqrt(2) sin(angle / 2)
        f = np.linalg.norm(p[:, :3, :3] - r[:, :3, :3], axis=(1, 2)) / (2.0 * math.sqrt(2.0))
        dr.append(2.0 * np.arcsin(np.minimum(f, 1.0)))
    return np.concatenate(dt), np.concatenate(dr)


def _codes(keys: torch.Tensor) -> torch.Tensor:
    k = keys.to(torch.int64) + (1 << 20)
    return (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]


def map_mismatch(prog, ref, voxel_size: float, labels=None) -> float:
    """1 - matched points / the larger map's points (among those with a
    label in `labels`, when given). prog, ref: (keys, counts, points) of
    two maps on one device."""
    tol = int(MATCH_TOLERANCE_M / (voxel_size / QSCALE))
    keys_p, counts_p, pts_p = prog[:3]
    keys_r, counts_r, pts_r = ref[:3]
    K = pts_p.shape[2]
    lane = torch.arange(K, device=pts_p.device)

    def live(keys, counts, pts):
        sel = counts > 0
        blocks = pts[sel]
        lanes = lane[None, :] < counts[sel][:, None]
        if labels is not None:
            lanes = lanes & torch.isin(blocks[:, 3, :].to(torch.int32), torch.tensor(labels, device=pts.device))
        return _codes(keys[sel]), counts[sel], blocks, lanes

    cp, np_, bp, lp = live(keys_p, counts_p, pts_p)
    cr, nr, br, lr = live(keys_r, counts_r, pts_r)
    total = max(int(lp.sum()), int(lr.sum()))
    if total == 0:
        return 0.0
    if len(cr) == 0 or len(cp) == 0:
        return 1.0
    order = torch.argsort(cr)
    j = order[torch.clamp(torch.searchsorted(cr[order], cp), max=len(cr) - 1)]
    found = cr[j] == cp
    a, b = bp[found], br[j[found]]
    both = (lane[None, :] < torch.minimum(np_[found], nr[j[found]])[:, None]) & lr[j[found]]
    same = (a[:, 3, :] == b[:, 3, :]) & (
        (a[:, :3, :].to(torch.int32) - b[:, :3, :].to(torch.int32)).abs().amax(dim=1) <= tol)
    return 1.0 - int((both & same).sum()) / total


def counter_gap(drives: list, ref_counters: list) -> int:
    gap = 0
    for d in drives:
        ref = ref_counters[: d.frames]
        for f in DROP_COUNTERS:
            gap += abs(int(d.totals[f]) - sum(c[f] for c in ref))
        gap += abs(int(d.landmark_cells_dropped) - sum(c["landmark_cells_dropped"] for c in ref))
    return gap


def numbers(cell, drives: list, prog_map, ref) -> dict:
    """Every number above: the program's runs of the checked drive and its
    map after the first run, against the reference that followed it."""
    cfg = cell.sage
    dt, dr = pose_gaps([d.poses for d in drives], ref.poses)
    ref_map = ref.state.map
    vehicles = list(cfg["voxel_labels"][cfg["dynamic_vehicle_voxid"]])
    return {
        "pose_gap_m": float(np.max(dt)), "rotation_gap_rad": float(np.max(dr)),
        "map_point_mismatch": map_mismatch(prog_map, ref_map, cfg["voxel_size_map"]),
        "vehicle_point_mismatch": map_mismatch(prog_map, ref_map, cfg["voxel_size_map"], vehicles),
        "counter_gap": counter_gap(drives, ref.counters),
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that `limits` names within its limit, {name:
    {"value", "limit"}})."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in checks.values()), checks
