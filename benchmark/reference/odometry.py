"""One odometry step of the reference, and a driver that feeds it scans.

The step, as upstream sageICP.cpp orders it:

    deskew (when configured, from the third pose on) -> preprocess ->
    dynamic vehicle filter (when configured) -> double class-adaptive
    voxel downsample -> adaptive threshold -> constant-velocity
    prediction -> semantic ICP -> solve health guard -> map insert ->
    distance cull

on fixed-capacity tensors of one device, eagerly, with every setting
read from the configuration's dict (the SageConfig fields of the
benchmark's configuration file)."""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from . import correspondence as corr
from . import deskew as dsk
from . import dynamic_filter as dyn
from . import icp
from . import voxel_map as vm
from .geometry import renormalize, rotation_angle, se3_inverse, transform_points
from .scan import INVALID_COORD, const, norm3, preprocess, trunc_div, voxel_downsample

# the silent-drop counters of a step, 0 in a healthy run
DROP_COUNTERS = ("corr_dropped", "ds_truncated", "insert_unique_overflow", "insert_claim_failures",
                 "insert_incoming_truncated", "dynfilter_overflow", "nonfinite_pose", "icp_rejected", "icp_forced")
QSCAN_SCALE = 1.0 / 256.0
QSCAN_INVALID = 32767
QTS_SCALE = 32767.0  # the int16 upload's unit of a point time: 1 / (2^15 - 1)


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matrix products in full float32 (tf32=False) or in TF32 on
    the card, for the duration."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class State(NamedTuple):
    map: vm.MapState
    last_pose: torch.Tensor
    prev_pose: torch.Tensor
    first_pose: torch.Tensor
    num_poses: torch.Tensor
    model_deviation: torch.Tensor
    sse: torch.Tensor
    num_samples: torch.Tensor
    reject_streak: torch.Tensor


def init_state(cfg: dict, device) -> State:
    eye = lambda: torch.eye(4, dtype=torch.float32, device=device)  # noqa: E731
    i32 = lambda: torch.zeros((), dtype=torch.int32, device=device)  # noqa: E731
    K = cfg["basic_points_per_voxel"] + cfg["critical_points_per_voxel"]
    return State(vm.create(cfg["map_capacity"], K, device), eye(), eye(), eye(), i32(), eye(),
                 torch.zeros((), device=device), i32(), i32())


def fast_params(cfg: dict) -> dict | None:
    ok = cfg["use_fast_correspondences"] and corr.fast_path_supported(
        cfg["voxel_size_map"], cfg["local_map_range"], cfg["max_range"])
    return dict(unique_voxel_rows=cfg["corr_unique_voxel_rows"], queries_per_voxel=cfg["corr_queries_per_voxel"],
                overflow_rows=cfg["corr_overflow_rows"]) if ok else None


def step(state: State, points, valid, cfg: dict, follow: torch.Tensor | None = None, timestamps=None):
    """(state, (cap, 4) scan rows, (cap,) valid) -> (state', pose, aux:
    {counter: 0-dim tensor}, live rows of each GN iteration run).

    follow: a (4, 4) pose that the state moves on with in place of the
    step's own: the map takes the frame at it, and the poses and the
    threshold's model deviation carry it; the step's own pose is still
    the one returned. timestamps: (cap,) sweep phases, read with deskew
    on."""
    dev = points.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    if cfg["deskew"]:
        moved = dsk.deskew(points, timestamps, state.prev_pose, state.last_pose)
        points = torch.where(state.num_poses > 2, moved, points)
    cropped, crop_valid = preprocess(points, valid, cfg["max_range"], cfg["min_range"], cfg["label_max_range"])
    dyn_overflow = lmk_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg["dynamic_vehicle_filter"]:
        cropped, crop_valid, dyn_overflow, lmk_dropped = dyn.filter_dynamic_vehicles(cropped, crop_valid, cfg)
    sizes = const(tuple(cfg["voxel_size"]), points.dtype, dev)
    labels = cfg["voxel_labels"]
    frame_ds, frame_valid, t1 = voxel_downsample(cropped, crop_valid, labels, sizes, 0.5, cfg["frame_capacity"])
    source, source_valid, t2 = voxel_downsample(frame_ds, frame_valid, labels, sizes, 1.5, cfg["source_capacity"])

    # adaptive threshold (upstream Threshold.cpp) and the prediction
    motion = norm3((se3_inverse(state.first_pose) @ state.last_pose)[:3, 3])
    has_moved = (state.num_poses > 0) & (motion > 5.0 * cfg["min_motion_th"])
    dv = state.model_deviation
    err = norm3(dv[:3, 3]) + 2.0 * cfg["max_range"] * torch.sin(rotation_angle(dv[:3, :3]) / 2.0)
    take = has_moved & (err > cfg["min_motion_th"])
    sse = torch.where(take, state.sse + err * err, state.sse)
    n = torch.where(take, state.num_samples + 1, state.num_samples)
    init = const(cfg["initial_threshold"], sse.dtype, dev)
    adaptive = torch.where(n < 1, init, torch.sqrt(sse / torch.clamp(n, min=1).to(sse.dtype)))
    sigma = torch.where(has_moved, adaptive, init)
    prediction = torch.where(state.num_poses < 2, eye, se3_inverse(state.prev_pose) @ state.last_pose)
    pred_ok = torch.all(torch.isfinite(prediction)) & (norm3(prediction[:3, 3]) <= cfg["max_range"])
    prediction = torch.where(pred_ok, prediction, eye)
    last = torch.where(state.num_poses > 0, state.last_pose, eye)
    last = torch.where(torch.all(torch.isfinite(last)), last, eye)
    guess = last @ prediction

    voxel = cfg["voxel_size_map"]
    max_corr, kernel = 3.0 * sigma, sigma / const(3.0, sigma.dtype, dev)
    fast = fast_params(cfg)
    tables = None
    if fast is not None:
        tables = corr.build_probe_tables(state.map, trunc_div(guess[:3, 3], voxel), cfg["probe_depth"])
        pose, iters, ncorr, dropped, live_rows = icp.frozen_rows_loop(
            state.map, tables, source, source_valid, guess, voxel, max_corr, kernel, cfg["sem_th"],
            cfg["max_icp_iterations"], fast)
    else:
        pose, iters, ncorr, dropped, live_rows = icp.reference_loop(
            state.map, source, source_valid, guess, voxel, max_corr, kernel, cfg["sem_th"],
            cfg["max_icp_iterations"], cfg["probe_depth"])

    # solve-health guard
    num_source = source_valid.sum(dtype=torch.int32)
    R = pose[:3, :3]
    ortho = torch.sum(torch.square(R.T @ R - torch.eye(3, device=dev)))
    pose_ok = torch.all(torch.isfinite(pose)) & (ortho < 1e-3)
    corr_ok = ncorr >= torch.div(num_source, 20, rounding_mode="floor")
    healthy = pose_ok & ((state.num_poses == 0) | corr_ok)
    forced = pose_ok & ~healthy & (state.reject_streak >= cfg["reject_streak_limit"])
    healthy = healthy | forced
    new_pose = renormalize(torch.where(healthy, pose, guess))
    own_pose = new_pose
    if follow is not None:
        new_pose = follow

    basic = torch.tensor([lab in cfg["basic_parts_labels"] for lab in range(260)], dtype=torch.bool, device=dev)
    new_map, ins = vm.insert(
        state.map, transform_points(new_pose, frame_ds), frame_valid & healthy, voxel, cfg["basic_points_per_voxel"],
        basic, cfg["max_incoming_per_voxel"], cfg["probe_depth"],
        min(cfg["insert_unique_capacity"], cfg["frame_capacity"]),
        None if tables is None else corr.slot_finder(tables))
    new_map = vm.remove_far(new_map, new_pose[:3, 3], cfg["local_map_range"])
    first = state.num_poses == 0
    new_state = State(new_map, new_pose, torch.where(first, new_pose, state.last_pose),
                      torch.where(first, new_pose, state.first_pose), state.num_poses + 1,
                      se3_inverse(guess) @ new_pose, sse, n,
                      torch.where(healthy, 0, state.reject_streak + 1).to(torch.int32))
    aux = dict(icp_iterations=iters, num_source=num_source, num_frame_ds=frame_valid.sum(dtype=torch.int32),
               corr_dropped=dropped, ds_truncated=t1 + t2, insert_unique_overflow=ins.unique_overflow,
               insert_claim_failures=ins.claim_failures, insert_incoming_truncated=ins.incoming_truncated,
               dynfilter_overflow=dyn_overflow, nonfinite_pose=(~pose_ok).to(torch.int32),
               icp_rejected=(pose_ok & ~healthy).to(torch.int32), icp_forced=forced.to(torch.int32),
               landmark_cells_dropped=lmk_dropped)
    return new_state, own_pose, aux, live_rows


def pad_scan(scan: np.ndarray, cfg: dict, device, timestamps=None):
    """The scan as the step takes it: (cap, 4) rows, the rest invalid;
    with quantized_scan_upload the coordinates rounded to 1/256 m as the
    int16 upload carries them. With deskew on, a timestamp lane beside
    them: the given point times, or without them the azimuth's phase,
    0 on invalid rows (with the int16 upload, rounded to 1/32767).
    Returns (points, valid, timestamps or None)."""
    cap = cfg["scan_capacity"]
    n = min(len(scan), cap)
    rows = np.asarray(scan[:n, :4], dtype=np.float32)
    pts = torch.full((cap, 4), INVALID_COORD, dtype=torch.float32)
    if cfg["quantized_scan_upload"]:
        q = np.clip(np.round(rows[:, :3] / QSCAN_SCALE), -32700, 32700).astype(np.int16)
        pts[:n, :3] = torch.from_numpy(q).to(torch.float32) * QSCAN_SCALE
        pts[:n, 3] = torch.from_numpy(rows[:, 3].astype(np.int16)).to(torch.float32)
    else:
        pts[:n] = torch.from_numpy(rows)
    valid = torch.arange(cap) < n
    lane = None
    if cfg["deskew"]:
        ts = dsk.azimuth_phase(rows[:, :3]) if timestamps is None else torch.as_tensor(
            np.asarray(timestamps[:n], dtype=np.float32))
        if cfg["quantized_scan_upload"]:
            ts = torch.clamp(torch.round(ts * QTS_SCALE), 0, QTS_SCALE) / QTS_SCALE
        lane = torch.zeros(cap, dtype=torch.float32)
        lane[:n] = ts
        lane = lane.to(device)
    return pts.to(device), valid.to(device), lane


class Reference:
    """Feeds scans to the reference step from an empty map, as a
    reinitialised odometry is fed. register(scan) returns the step's pose
    (4, 4) float32 on the host and keeps, per frame, the counters (host
    ints, landmark cells dropped among them), the ICP iterations and the
    live correspondence rows of each GN iteration run.

    register(scan, follow=pose) judges a trajectory one step at a time:
    the step starts from the state that the followed poses of the earlier
    frames built (the map holding each frame at its followed pose), and
    its own pose for this frame is returned; the state then moves on with
    the followed pose (step's `follow`). With deskew on, a frame is
    deskewed with the state's two last poses, the followed ones when it
    follows; register(scan, timestamps) gives its points' sweep phases
    (without them, the azimuth's phase stands in)."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.state = init_state(cfg, self.device)
        self.poses: list[np.ndarray] = []
        self.counters: list[dict] = []
        self.live_rows: list[list[int]] = []

    def register(self, scan: np.ndarray, timestamps: np.ndarray | None = None,
                 follow: np.ndarray | None = None) -> np.ndarray:
        pts, valid, stamps = pad_scan(scan, self.cfg, self.device, timestamps)
        if follow is not None:
            follow = torch.as_tensor(np.asarray(follow, dtype=np.float32), device=self.device)
        self.state, pose, aux, live_rows = step(self.state, pts, valid, self.cfg, follow, stamps)
        self.counters.append({k: int(v) for k, v in aux.items()})
        self.live_rows.append(live_rows)
        self.poses.append(pose.cpu().numpy())
        return self.poses[-1]

    def map_copy(self) -> vm.MapState:
        return vm.MapState(*[t.clone() for t in self.state.map])
