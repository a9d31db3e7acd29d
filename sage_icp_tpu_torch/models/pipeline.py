"""The SAGE-ICP odometry pipeline on PyTorch tensors.

One step (odometry_step) runs, as in the reference's sageICP.cpp:

    deskew (when configured, from the third pose on) -> preprocess ->
    dynamic vehicle filter (when configured) -> double class-adaptive
    voxel downsample -> adaptive threshold -> constant-velocity
    prediction -> semantic ICP -> solve health guard -> map insert ->
    distance cull

on fixed-capacity tensors of one device, and SageICP wraps it with the
host-side padding, the trajectory log and the chunked offline mode. A
scan goes to the device as one packed (cap, 4|5) buffer: xyz, label and,
with deskew on, a timestamp lane; float32, or int16 with
quantized_scan_upload. The configuration and presets are this package's
own copy of the JAX reference's (field for field); SageICP() runs the
default, the production `kitti` preset.

Not in this package: the dense grid index (default off in the reference
and measured slower there); a configuration that turns it on is refused
(check_supported).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from sage_icp_tpu_torch.datasets.kitti import azimuth_timestamps
from sage_icp_tpu_torch.ops import correspondence_fast as cf
from sage_icp_tpu_torch.ops import dynamic_filter as dyn
from sage_icp_tpu_torch.ops import geometry as geo
from sage_icp_tpu_torch.ops import hashmap as hm
from sage_icp_tpu_torch.ops import registration as reg
from sage_icp_tpu_torch.ops import scan as scan_ops


@dataclasses.dataclass(frozen=True)
class SageConfig:
    """All tunables; defaults are the reference's KITTI variant. See the
    JAX package's SageConfig for the provenance of every capacity."""

    voxel_labels: tuple = (
        (40, 44, 48, 49),  # road
        (50, 51, 52),  # building
        (70, 72),  # plant
        (60, 71, 80, 81, 99),  # object
        (0,),  # unlabelled
        (10, 11, 13, 15, 16, 18, 20),  # vehicle
    )
    voxel_size: tuple = (0.6, 1.0, 0.9, 0.8, 1.0, 0.6)

    # map
    voxel_size_map: float = 0.8
    local_map_range: float = 100.0
    basic_points_per_voxel: int = 20
    critical_points_per_voxel: int = 20
    basic_parts_labels: tuple = (40, 44, 48, 49, 50, 70, 72)

    # preprocessing
    max_range: float = 100.0
    min_range: float = 5.0
    label_max_range: float = 50.0
    deskew: bool = False

    # dynamic vehicle filter
    dynamic_vehicle_filter: bool = True
    dynamic_vehicle_filter_th: float = 0.5
    dynamic_vehicle_voxid: int = 5
    dynamic_remove_landmark: tuple = (44, 48)

    # semantic association + adaptive threshold
    sem_th: float = 0.4
    initial_threshold: float = 2.0
    min_motion_th: float = 0.1

    # fixed capacities
    scan_capacity: int = 135_168
    frame_capacity: int = 65_536
    source_capacity: int = 20_480
    map_capacity: int = 262_144
    probe_depth: int = 12
    max_incoming_per_voxel: int = 48
    insert_unique_capacity: int = 33_024
    use_fast_correspondences: bool = True
    dense_grid: bool = False
    quantized_scan_upload: bool = False
    dense_grid_z_extent: float = 40.0
    corr_unique_voxel_rows: int = 16_384
    corr_queries_per_voxel: int = 2
    corr_overflow_rows: int = 2048
    max_icp_iterations: int = 500
    reject_streak_limit: int = 5
    dtype: str = "float32"

    @property
    def points_per_voxel(self) -> int:
        return self.basic_points_per_voxel + self.critical_points_per_voxel


PRESETS = {
    "kitti": SageConfig(),
    "kitti360": SageConfig(voxel_size=(1.0, 0.5, 1.0, 0.5, 1.0, 0.5), voxel_size_map=1.0, sem_th=0.8),
    "kitti_gt": SageConfig(sem_th=0.05, dynamic_vehicle_filter=False),
    "kitti_raw": SageConfig(voxel_size=(1.2, 1.0, 1.2, 0.2, 1.0, 0.5), voxel_size_map=1.0, sem_th=0.2),
    "synthetic": SageConfig(
        dynamic_vehicle_filter=False, min_range=2.0, scan_capacity=65_536, frame_capacity=32_768,
        source_capacity=8_192, map_capacity=65_536, insert_unique_capacity=8_448,
        corr_unique_voxel_rows=4096, corr_overflow_rows=512,
    ),
    # the Manhattan city world at density 0.7: this slice's main path
    "city": SageConfig(
        dynamic_vehicle_filter=False, min_range=2.0, scan_capacity=32_768, frame_capacity=28_672,
        source_capacity=12_288, map_capacity=131_072, insert_unique_capacity=16_896,
        corr_unique_voxel_rows=10_240, corr_overflow_rows=1_024,
    ),
    "geometric": SageConfig(
        voxel_labels=(tuple(range(260)),), voxel_size=(1.0,), voxel_size_map=1.0, sem_th=1.0,
        label_max_range=0.0, dynamic_vehicle_filter=False, basic_points_per_voxel=20,
        critical_points_per_voxel=0,
    ),
}


class ThresholdState(NamedTuple):
    """Adaptive threshold state (reference core/Threshold.hpp)."""

    model_deviation: torch.Tensor  # (4, 4)
    sse: torch.Tensor  # 0-dim f32
    num_samples: torch.Tensor  # 0-dim int32


class OdomState(NamedTuple):
    map: hm.MapState
    last_pose: torch.Tensor  # (4, 4) poses[N-1]
    prev_pose: torch.Tensor  # (4, 4) poses[N-2]
    first_pose: torch.Tensor  # (4, 4) poses[0]
    num_poses: torch.Tensor  # 0-dim int32
    threshold: ThresholdState
    reject_streak: torch.Tensor  # 0-dim int32 consecutive rejected frames


class StepAux(NamedTuple):
    """Per-frame diagnostics, 0-dim tensors. The counters after
    num_frame_ds are silent-drop channels: 0 = healthy."""

    sigma: torch.Tensor
    icp_iterations: torch.Tensor
    num_correspondences: torch.Tensor
    num_source: torch.Tensor
    num_frame_ds: torch.Tensor
    corr_dropped: torch.Tensor  # ICP queries without a correspondence row
    ds_truncated: torch.Tensor  # downsample outputs beyond capacity
    insert_unique_overflow: torch.Tensor
    insert_claim_failures: torch.Tensor
    insert_incoming_truncated: torch.Tensor
    dynfilter_overflow: torch.Tensor
    nonfinite_pose: torch.Tensor  # ICP pose non-finite or not orthonormal
    icp_rejected: torch.Tensor  # finite solve below the correspondence floor
    icp_forced: torch.Tensor  # below-floor solve accepted by the escape hatch

    def overflow_total(self):
        """Sum of every silent-drop channel: 0 in a healthy run."""
        return (
            self.corr_dropped + self.ds_truncated + self.insert_unique_overflow
            + self.insert_claim_failures + self.insert_incoming_truncated
            + self.dynfilter_overflow + self.nonfinite_pose + self.icp_rejected + self.icp_forced
        )


# aux_totals keeps the last frame's value of these, the max of the
# occupancy stats, and the sum of every counter
_AUX_LAST = ("sigma", "icp_iterations", "num_correspondences")
_AUX_MAX = ("num_source", "num_frame_ds")


def _eye(device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def _i32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def init_state(config: SageConfig, device) -> OdomState:
    return OdomState(
        map=hm.create(config.map_capacity, config.points_per_voxel, device),
        last_pose=_eye(device), prev_pose=_eye(device), first_pose=_eye(device),
        num_poses=_i32(0, device),
        threshold=ThresholdState(_eye(device), torch.zeros((), device=device), _i32(0, device)),
        reject_streak=_i32(0, device),
    )


def compute_model_error(deviation: torch.Tensor, max_range) -> torch.Tensor:
    """reference core/Threshold.cpp:29-34."""
    theta = geo.rotation_angle(deviation[:3, :3])
    delta_rot = 2.0 * max_range * torch.sin(theta / 2.0)
    return scan_ops.norm3(deviation[:3, 3]) + delta_rot


def _adaptive_sigma(ts: ThresholdState, has_moved, config: SageConfig):
    """sigma and the threshold-state update: the initial threshold until
    the vehicle has moved; afterwards model errors above min_motion_th
    accumulate into the SSE (reference Threshold.cpp:39-50)."""
    err = compute_model_error(ts.model_deviation, config.max_range)
    take = has_moved & (err > config.min_motion_th)
    sse = torch.where(take, ts.sse + err * err, ts.sse)
    n = torch.where(take, ts.num_samples + 1, ts.num_samples)
    init = torch.tensor(config.initial_threshold, dtype=sse.dtype, device=sse.device)
    adaptive = torch.where(n < 1, init, torch.sqrt(sse / torch.clamp(n, min=1).to(sse.dtype)))
    sigma = torch.where(has_moved, adaptive, init)
    return sigma, ThresholdState(ts.model_deviation, sse, n)


def voxelize(points, valid, config: SageConfig):
    """Double downsample: the map frame at 0.5x the group voxel sizes, the
    ICP sources at a further 1.5x. Returns ((source, source_valid),
    (frame, frame_valid), truncated)."""
    sizes = torch.tensor(config.voxel_size, dtype=points.dtype, device=points.device)
    frame, frame_valid, t1 = scan_ops.voxel_downsample(
        points, valid, config.voxel_labels, sizes, 0.5, config.frame_capacity)
    source, source_valid, t2 = scan_ops.voxel_downsample(
        frame, frame_valid, config.voxel_labels, sizes, 1.5, config.source_capacity)
    return (source, source_valid), (frame, frame_valid), t1 + t2


def _fast_ok(config: SageConfig) -> bool:
    return config.use_fast_correspondences and cf.fast_path_supported(
        config.voxel_size_map, config.local_map_range, config.max_range)


def prepare_icp_inputs(state: OdomState, points, valid, timestamps, config: SageConfig) -> dict:
    """Everything of the step before the ICP solve. timestamps (cap,) in
    [0, 1] are read only with config.deskew."""
    dev = points.device
    eye = _eye(dev)
    if config.deskew:
        # gated on the device (no host sync): from the third pose on
        deskewed = scan_ops.deskew(points, timestamps, state.prev_pose, state.last_pose)
        points = torch.where(state.num_poses > 2, deskewed, points)
    cropped, crop_valid = scan_ops.preprocess(
        points, valid, config.max_range, config.min_range, config.label_max_range)
    dyn_overflow = _i32(0, dev)
    if config.dynamic_vehicle_filter:
        cropped, crop_valid, dyn_overflow = dyn.filter_dynamic_vehicles(cropped, crop_valid, config)
    (source, source_valid), (frame_ds, frame_valid), ds_trunc = voxelize(cropped, crop_valid, config)

    motion = scan_ops.norm3((geo.se3_inverse(state.first_pose) @ state.last_pose)[:3, 3])
    has_moved = (state.num_poses > 0) & (motion > 5.0 * config.min_motion_th)
    sigma, thr = _adaptive_sigma(state.threshold, has_moved, config)

    prediction = torch.where(
        state.num_poses < 2, eye, geo.se3_inverse(state.prev_pose) @ state.last_pose)
    # teleport clamp: a prediction beyond the sensor range (or non-finite)
    # means the carried poses are corrupt; coast in place instead
    pred_ok = torch.all(torch.isfinite(prediction)) & (scan_ops.norm3(prediction[:3, 3]) <= config.max_range)
    prediction = torch.where(pred_ok, prediction, eye)
    last = torch.where(state.num_poses > 0, state.last_pose, eye)
    last = torch.where(torch.all(torch.isfinite(last)), last, eye)
    initial_guess = last @ prediction

    tables = None
    if _fast_ok(config):
        # one probe-table build per step, shared by the solve and the insert
        tables = cf.build_probe_tables(
            state.map, scan_ops.trunc_div(initial_guess[:3, 3], config.voxel_size_map), config.probe_depth)
    return dict(source=source, source_valid=source_valid, frame_ds=frame_ds, frame_valid=frame_valid,
                sigma=sigma, thr=thr, initial_guess=initial_guess, tables=tables, ds_trunc=ds_trunc,
                dyn_overflow=dyn_overflow)


def run_icp(map_state, prep: dict, config: SageConfig, mesh=None) -> reg.IcpResult:
    """max_corr_dist = 3 sigma, robust kernel = sigma / 3. With a mesh
    (parallel.sharding.Mesh) the GN rows are split across its ranks."""
    fast_params = dict(
        unique_voxel_rows=config.corr_unique_voxel_rows,
        queries_per_voxel=config.corr_queries_per_voxel,
        overflow_rows=config.corr_overflow_rows,
    ) if _fast_ok(config) else None
    sigma = prep["sigma"]
    return reg.register_frame(
        map_state, prep["source"], prep["source_valid"], prep["initial_guess"], config.voxel_size_map,
        3.0 * sigma, sigma / 3.0, config.sem_th, max_iterations=config.max_icp_iterations,
        probe_depth=config.probe_depth, fast_params=fast_params, tables=prep["tables"], mesh=mesh,
    )


def basic_label_mask(config: SageConfig, device, num_labels: int = 260) -> torch.Tensor:
    m = torch.zeros((num_labels,), dtype=torch.bool, device=device)
    m[list(config.basic_parts_labels)] = True
    return m


def check_supported(config: SageConfig) -> None:
    """Refuse the setting this package does not implement, rather than
    ignore it."""
    if config.dense_grid:
        raise NotImplementedError("not ported: dense_grid")


def odometry_step(state: OdomState, points, valid, timestamps, config: SageConfig, mesh=None,
                  shard_insert: bool = True):
    """One odometry step. points (scan_capacity, 4) sensor-frame
    xyz+label; valid (scan_capacity,); timestamps (scan_capacity,) in
    [0, 1], read only with config.deskew. Returns (new_state, pose (4, 4),
    aux). The ICP loop waits for the device at its start and once per
    iteration (ops/registration.py).

    mesh (parallel.sharding.Mesh): every rank steps the whole scan; the
    GN rows and, with shard_insert, the insert's policy rows are split
    across the ranks (parallel/sharding.py)."""
    check_supported(config)
    dev = points.device
    prep = prepare_icp_inputs(state, points, valid, timestamps, config)
    source_valid = prep["source_valid"]
    frame_ds, frame_valid = prep["frame_ds"], prep["frame_valid"]
    initial_guess = prep["initial_guess"]

    icp = run_icp(state.map, prep, config, mesh)
    # solve-health guard: a non-finite or non-orthonormal pose, or a
    # finite solve that matched almost nothing, coasts on the motion
    # model and skips this frame's insert; after reject_streak_limit
    # rejections in a row the next finite solve is accepted anyway
    num_source = source_valid.sum(dtype=torch.int32)
    R = icp.pose[:3, :3]
    ortho = torch.sum(torch.square(R.T @ R - torch.eye(3, device=dev)))
    pose_ok = torch.all(torch.isfinite(icp.pose)) & (ortho < 1e-3)
    corr_ok = icp.num_correspondences >= torch.div(num_source, 20, rounding_mode="floor")
    healthy = pose_ok & ((state.num_poses == 0) | corr_ok)
    forced = pose_ok & ~healthy & (state.reject_streak >= config.reject_streak_limit)
    healthy = healthy | forced
    new_pose = geo.renormalize(torch.where(healthy, icp.pose, initial_guess))

    thr = prep["thr"]
    thr = ThresholdState(geo.se3_inverse(initial_guess) @ new_pose, thr.sse, thr.num_samples)

    new_map, ins = hm.insert(
        state.map, geo.transform_points(new_pose, frame_ds), frame_valid & healthy,
        config.voxel_size_map, config.basic_points_per_voxel, basic_label_mask(config, dev),
        max_incoming_per_voxel=config.max_incoming_per_voxel, probe_depth=config.probe_depth,
        unique_voxel_capacity=min(config.insert_unique_capacity, config.frame_capacity),
        tables=prep["tables"], mesh=mesh if shard_insert else None,
    )
    new_map = hm.remove_far(new_map, new_pose[:3, 3], config.local_map_range)

    first = state.num_poses == 0
    new_state = OdomState(
        map=new_map,
        last_pose=new_pose,
        prev_pose=torch.where(first, new_pose, state.last_pose),
        first_pose=torch.where(first, new_pose, state.first_pose),
        num_poses=state.num_poses + 1,
        threshold=thr,
        reject_streak=torch.where(healthy, 0, state.reject_streak + 1).to(torch.int32),
    )
    aux = StepAux(
        sigma=prep["sigma"],
        icp_iterations=_i32(icp.iterations, dev),
        num_correspondences=_i32(icp.num_correspondences, dev),
        num_source=num_source,
        num_frame_ds=frame_valid.sum(dtype=torch.int32),
        corr_dropped=icp.dropped_queries,
        ds_truncated=prep["ds_trunc"],
        insert_unique_overflow=ins.unique_overflow,
        insert_claim_failures=ins.claim_failures,
        insert_incoming_truncated=ins.incoming_truncated,
        dynfilter_overflow=prep["dyn_overflow"],
        nonfinite_pose=(~pose_ok).to(torch.int32),
        icp_rejected=(pose_ok & ~healthy).to(torch.int32),
        icp_forced=forced.to(torch.int32),
    )
    return new_state, new_pose, aux


# int16 upload: xyz in units of 2^-8 m; an invalid row holds 32767 in
# lane 0 (no real coordinate reaches +127.996 m after the range crop);
# timestamps scale by 2^15 - 1
QSCAN_SCALE = 1.0 / 256.0
QSCAN_INVALID = 32767
QTS_SCALE = 32767.0


def _split_packed(pts: torch.Tensor):
    """(cap, 4|5) packed buffer -> (points (cap, 4), valid, timestamps).
    Lane 4, when present, holds per-point timestamps; validity comes from
    the pad sentinel. int16 buffers are the quantized upload format."""
    if pts.dtype == torch.int16:
        valid = pts[:, 0] != QSCAN_INVALID
        xyz = pts[:, :3].to(torch.float32) * QSCAN_SCALE
        lab = pts[:, 3:4].to(torch.float32)
        out = torch.where(valid[:, None], torch.cat([xyz, lab], dim=-1), scan_ops.INVALID_COORD)
        if pts.shape[1] == 5:
            ts = torch.where(valid, pts[:, 4].to(torch.float32) / QTS_SCALE, 0.0)
        else:
            ts = torch.zeros(pts.shape[0], dtype=torch.float32, device=pts.device)
        return out, valid, ts
    valid = pts[:, 0] < 1.0e6  # INVALID_COORD sentinel
    if pts.shape[1] == 5:
        return pts[:, :4], valid, torch.where(valid, pts[:, 4], 0.0)
    return pts, valid, torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device)


def _quantize_scan_host(rows: np.ndarray, out: np.ndarray) -> None:
    """Host-side int16 packing of (n, 4|5) float rows into out[:n]."""
    n = len(rows)
    out[:n, :3] = np.clip(np.round(rows[:, :3] / QSCAN_SCALE), -32700, 32700).astype(np.int16)
    out[:n, 3] = rows[:, 3].astype(np.int16)
    if out.shape[1] == 5 and rows.shape[1] >= 5:
        out[:n, 4] = np.clip(np.round(rows[:, 4] * QTS_SCALE), 0, 32767).astype(np.int16)


def _fold_aux(totals: StepAux | None, aux: StepAux) -> StepAux:
    """Running totals: the last frame's sigma, iterations and
    correspondences, the max of the occupancy stats, every counter summed."""
    if totals is None:
        return aux
    return StepAux(*[
        a if f in _AUX_LAST else torch.maximum(t, a) if f in _AUX_MAX else t + a
        for f, t, a in zip(StepAux._fields, totals, aux)
    ])


def chunk_step(state: OdomState, scans: torch.Tensor, config: SageConfig, mesh=None):
    """Offline mode: (state, scans (W, cap, 4|5) on the device) -> (state',
    poses (W, 4, 4) on the device, per-frame ICP iterations (list of W
    ints), aux aggregated over the chunk: drop counters summed, occupancy
    maxed, sigma/iterations/correspondences of the last frame). The W
    steps are the single-frame steps in order, on one upload (sharded
    on `mesh` when given)."""
    poses, iters, agg = [], [], None
    for pts in scans:
        p, valid, ts = _split_packed(pts)
        state, pose, aux = odometry_step(state, p, valid, ts, config, mesh)
        poses.append(pose)
        iters.append(int(aux.icp_iterations))
        agg = _fold_aux(agg, aux)
    return state, torch.stack(poses), iters, agg


def resolve_device(device=None) -> torch.device:
    """None means the card. Without one, only an explicit "cpu" runs:
    the port never falls back to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to run on the CPU')
    return device


class SageICP:
    """Stateful wrapper: pads scans to the fixed capacity, steps the
    pipeline on `device` (default the card) and keeps the trajectory and
    running totals of the per-frame counters (no per-frame aux log)."""

    def __init__(self, config: SageConfig | str = "kitti", device=None):
        if isinstance(config, str):
            config = PRESETS[config]
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        self.mesh = None  # parallel.sharding.ShardedSageICP sets its mesh
        geo.pin_full_fp32()
        self.reinitialize()

    def reinitialize(self):
        """Empty map, empty trajectory (reference sageICP.hpp:94-99)."""
        self.state = init_state(self.config, self.device)
        self.poses: list = []  # (4, 4) numpy, or device tensors (4, 4) / (W, 4, 4)
        self.timings: list[float] = []
        self.icp_iters: list[int] = []
        self._last_aux = None
        self._totals = None

    def pad_chunk(self, scans: list, timestamps: list | None = None) -> np.ndarray:
        """(W, scan_capacity, 4|5) packed host buffer: float32 rows padded
        with INVALID_COORD, or int16 (quantized_scan_upload) padded with
        QSCAN_INVALID. With deskew on, lane 4 holds per-point timestamps
        (given, or the azimuth phase)."""
        cfg = self.config
        cap = cfg.scan_capacity
        lanes = 5 if cfg.deskew else 4
        if cfg.quantized_scan_upload:
            buf = np.full((len(scans), cap, lanes), QSCAN_INVALID, dtype=np.int16)
        else:
            buf = np.full((len(scans), cap, lanes), scan_ops.INVALID_COORD, dtype=np.float32)
        for i, s in enumerate(scans):
            n = min(len(s), cap)
            rows = np.asarray(s[:n, :4], dtype=np.float32)
            if lanes == 5:
                ts = timestamps[i] if timestamps is not None else None
                ts = azimuth_timestamps(rows[:, :3]) if ts is None else ts[:n]
                rows = np.concatenate([rows, np.asarray(ts, np.float32)[:, None]], axis=1)
            if cfg.quantized_scan_upload:
                _quantize_scan_host(rows, buf[i])
            else:
                buf[i, :n] = rows
        return buf

    def _record(self, aux: StepAux, iters: list[int]) -> None:
        self._last_aux = aux
        self._totals = _fold_aux(self._totals, aux)
        self.icp_iters.extend(iters)

    def register_frame(self, points: np.ndarray, timestamps: np.ndarray | None = None,
                       block: bool = True):
        """points (n, 4) float xyz+label -> the 4x4 pose. timestamps (n,)
        in [0, 1] are used with deskew on; without them the azimuth phase
        stands in. block=False returns the pose as a device tensor without
        waiting; trajectory() fetches it."""
        buf = self.pad_chunk([points], None if timestamps is None else [timestamps])[0]
        t0 = time.perf_counter()
        pts, valid, ts = _split_packed(torch.from_numpy(buf).to(self.device))
        self.state, pose, aux = odometry_step(self.state, pts, valid, ts, self.config, self.mesh)
        self._record(aux, [int(aux.icp_iterations)])
        if block:
            pose = pose.cpu().numpy()
        self.timings.append(time.perf_counter() - t0)
        self.poses.append(pose)
        return pose

    def register_chunk(self, scans, timestamps: list | None = None) -> torch.Tensor:
        """Offline mode: W frames on one upload (chunk_step). scans: a list
        of (n, 4) arrays or a padded (W, cap, 4|5) buffer from pad_chunk.
        Appends the (W, 4, 4) device poses to the trajectory and returns
        them without waiting."""
        if isinstance(scans, list):
            scans = self.pad_chunk(scans, timestamps)
        dev_scans = torch.as_tensor(scans).to(self.device)
        self.state, poses, iters, aux = chunk_step(self.state, dev_scans, self.config, self.mesh)
        self._record(aux, iters)
        self.poses.append(poses)
        return poses

    def iteration_counts(self) -> np.ndarray:
        """(N,) per-frame ICP iteration counts."""
        return np.asarray(self.icp_iters, dtype=np.int32)

    @property
    def last_aux(self) -> StepAux:
        """The last call's aux: a frame's, or a chunk's aggregate."""
        return StepAux(*[np.asarray(a.cpu()) for a in self._last_aux])

    def aux_totals(self) -> StepAux:
        """Counters over every frame since the last reinitialize: drop
        counters summed, occupancy maxed, sigma/iterations/correspondences
        of the last frame."""
        return StepAux(*[np.asarray(a.cpu()) for a in self._totals])

    def trajectory(self) -> np.ndarray:
        """(N, 4, 4) poses; the poses held on the device come over in one
        transfer."""
        if not self.poses:
            return np.zeros((0, 4, 4))
        held = [p.reshape(-1, 4, 4) for p in self.poses if torch.is_tensor(p)]
        fetched = iter(torch.cat(held).cpu().numpy()) if held else None
        out = []
        for p in self.poses:
            if torch.is_tensor(p):
                out.extend(next(fetched) for _ in range(p.reshape(-1, 4, 4).shape[0]))
            else:
                out.append(np.asarray(p).reshape(4, 4))
        return np.stack(out)

    def local_map(self) -> np.ndarray:
        pts, mask = hm.pointcloud(self.state.map, self.config.voxel_size_map)
        return pts[mask].cpu().numpy()
