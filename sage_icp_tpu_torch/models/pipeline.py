"""The SAGE-ICP odometry pipeline on PyTorch tensors.

One step (odometry_step) runs, as in the reference's sageICP.cpp:

    deskew (when configured, from the third pose on) -> preprocess ->
    dynamic vehicle filter (when configured) -> double class-adaptive
    voxel downsample -> adaptive threshold -> constant-velocity
    prediction -> semantic ICP -> solve health guard -> map insert ->
    distance cull

on fixed-capacity tensors of one device. make_step, make_step_packed
and make_chunk_step (DeviceStep) run it as a device program, the JAX
package's jitted steps: the state donated and updated in place, the ICP
loop on the device (either branch), and on the card the frame captured as
CUDA graphs, also over a mesh of NCCL ranks (parallel/sharding.py).
SageICP wraps that step with the host-side padding, the trajectory log
and the chunked offline mode. A
scan goes to the device as one packed (cap, 4|5) buffer: xyz, label and,
with deskew on, a timestamp lane; float32, or int16 with
quantized_scan_upload. The configuration and presets are this package's
own copy of the JAX reference's (field for field); SageICP() runs the
default, the production `kitti` preset. dense_grid=True keeps the map's
dense voxel index (ops/hashmap.py) and looks voxels up through it; the
trajectory and the map are the same as without it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from sage_icp_tpu_torch.datasets.kitti import azimuth_timestamps
from sage_icp_tpu_torch.ops import correspondence_fast as cf
from sage_icp_tpu_torch.ops import dynamic_filter as dyn
from sage_icp_tpu_torch.ops import geometry as geo
from sage_icp_tpu_torch.ops import hashmap as hm
from sage_icp_tpu_torch.ops import icp_kernel as ik
from sage_icp_tpu_torch.ops import registration as reg
from sage_icp_tpu_torch.ops import scan as scan_ops
from sage_icp_tpu_torch.ops.constants import device_constant
from sage_icp_tpu_torch.runtime import tracing


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
    """A fresh 0-dim int32 (a fill on the device, no upload)."""
    return torch.full((), v, dtype=torch.int32, device=device)


def check_dense_grid(config: SageConfig) -> None:
    """The dense index is alias-free only while every live voxel of the
    culled map has a torus cell of its own: refuse a configuration whose
    map could span the period (as the JAX package's init_state does)."""
    if not config.dense_grid:
        return
    span = 2.0 * config.local_map_range / config.voxel_size_map + 4
    if span >= 1 << hm.GRID_XY_BITS:
        raise ValueError(f"dense_grid needs the culled map to span < {1 << hm.GRID_XY_BITS} voxels, "
                         f"local_map_range={config.local_map_range} at voxel_size_map={config.voxel_size_map} "
                         f"spans {span:g}: lower local_map_range, raise voxel_size_map, or set dense_grid=False")
    zspan = config.dense_grid_z_extent / config.voxel_size_map + 4
    if zspan >= 1 << hm.GRID_Z_BITS:
        raise ValueError(f"dense_grid's z period ({1 << hm.GRID_Z_BITS} voxels) cannot hold "
                         f"dense_grid_z_extent={config.dense_grid_z_extent} m at voxel_size_map="
                         f"{config.voxel_size_map} ({zspan:g} voxels): raise voxel_size_map, lower "
                         "dense_grid_z_extent, or set dense_grid=False")


def init_state(config: SageConfig, device) -> OdomState:
    check_dense_grid(config)
    return OdomState(
        map=hm.create(config.map_capacity, config.points_per_voxel, device, dense_grid=config.dense_grid),
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
    init = device_constant(config.initial_threshold, sse.dtype, sse.device)
    adaptive = torch.where(n < 1, init, torch.sqrt(sse / torch.clamp(n, min=1).to(sse.dtype)))
    sigma = torch.where(has_moved, adaptive, init)
    return sigma, ThresholdState(ts.model_deviation, sse, n)


def voxelize(points, valid, config: SageConfig):
    """Double downsample: the map frame at 0.5x the group voxel sizes, the
    ICP sources at a further 1.5x. Returns ((source, source_valid),
    (frame, frame_valid), truncated)."""
    sizes = device_constant(config.voxel_size, points.dtype, points.device)
    frame, frame_valid, t1 = scan_ops.voxel_downsample(
        points, valid, config.voxel_labels, sizes, 0.5, config.frame_capacity)
    source, source_valid, t2 = scan_ops.voxel_downsample(
        frame, frame_valid, config.voxel_labels, sizes, 1.5, config.source_capacity)
    return (source, source_valid), (frame, frame_valid), t1 + t2


def _fast_ok(config: SageConfig) -> bool:
    return config.use_fast_correspondences and cf.fast_path_supported(
        config.voxel_size_map, config.local_map_range, config.max_range)


def _no_stamp(slot, value=None, into=None) -> None:
    """The stage clock's split where a step has no clock."""


def scan_head(state: OdomState, points, valid, timestamps, config: SageConfig, mesh=None, stamp=None):
    """Deskew (with config.deskew, from the third pose on) and preprocess:
    (cropped (cap, 4), crop_valid (cap,)).

    stamp: the step's stage clock (tracing.StageClock.split). With deskew
    it ends the `deskew` stage after the deskew and writes the frame's
    deskewed points (the scan's valid rows from the third pose on, 0
    before: a count on the device, never read here); then it ends the
    `head` stage after the crop (and a mesh's gather). Without deskew the
    `head` stamp alone.

    mesh (parallel.sharding.Mesh), with deskew on: each rank deskews and
    crops its contiguous share of the scan's points (Mesh.local_rows), and
    one all-gather of the rows (their mask as a fifth float lane) rebuilds
    the whole cropped scan on every rank, as the JAX package's SPMD step
    gathers around the downsample's sort. A point's deskew and crop do not
    depend on the others (scan.deskew has no batched product), so the
    result is the unsharded head's bit for bit. Without deskew the head
    stays whole on every rank: the crop alone costs less than the split
    and its gather (0.028 against 0.060 device ms a kitti scan on two
    H100s over NVLink); with deskew the two cost about the same (0.58
    whole, 0.59 split: PERF.md)."""
    stamp = stamp or _no_stamp
    n = points.shape[0]
    split = mesh is not None and config.deskew
    if config.deskew:
        # gated on the device (no host sync): from the third pose on
        deskewing = state.num_poses > 2
        moved = torch.where(deskewing, valid.sum(dtype=torch.int32), 0)
    if split:
        points, valid, timestamps = (mesh.local_rows(x) for x in (points, valid, timestamps))
    if config.deskew:
        deskewed = scan_ops.deskew(points, timestamps, state.prev_pose, state.last_pose)
        points = torch.where(deskewing, deskewed, points)
        stamp(tracing.DESKEW, moved, tracing.DESKEWED_POINTS)
    cropped, crop_valid = scan_ops.preprocess(
        points, valid, config.max_range, config.min_range, config.label_max_range)
    if split:
        rows = mesh.gather_rows(torch.cat([cropped, crop_valid[:, None].to(cropped.dtype)], dim=1), n)
        cropped, crop_valid = rows[:, :4], rows[:, 4] != 0
    stamp(tracing.HEAD)
    return cropped, crop_valid


def prepare_icp_inputs(state: OdomState, points, valid, timestamps, config: SageConfig, mesh=None,
                       stamp=None) -> dict:
    """Everything of the step before the ICP solve. timestamps (cap,) in
    [0, 1] are read only with config.deskew. mesh: the scan head and the
    dynamic filter split their per-point work across its ranks
    (scan_head, dynamic_filter.filter_dynamic_vehicles); the downsample
    and everything after it here stay whole on every rank. stamp: the
    step's stage clock (tracing.StageClock.split), called with the stage
    after the deskew and the crop (scan_head), the filter and the
    downsample."""
    dev = points.device
    eye = _eye(dev)
    stamp = stamp or _no_stamp
    cropped, crop_valid = scan_head(state, points, valid, timestamps, config, mesh, stamp)
    dyn_overflow = lmk_dropped = _i32(0, dev)
    if config.dynamic_vehicle_filter:
        cropped, crop_valid, dyn_overflow, lmk_dropped = dyn.filter_dynamic_vehicles(cropped, crop_valid, config,
                                                                                      mesh)
        stamp(tracing.FILTER)
    (source, source_valid), (frame_ds, frame_valid), ds_trunc = voxelize(cropped, crop_valid, config)
    stamp(tracing.DOWNSAMPLE)

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
                dyn_overflow=dyn_overflow, lmk_dropped=lmk_dropped)


def _fast_params(config: SageConfig):
    return dict(
        unique_voxel_rows=config.corr_unique_voxel_rows,
        queries_per_voxel=config.corr_queries_per_voxel,
        overflow_rows=config.corr_overflow_rows,
    ) if _fast_ok(config) else None


def _icp_args(map_state, prep: dict, config: SageConfig):
    """max_corr_dist = 3 sigma, robust kernel = sigma / 3 (divided on the
    device by a device 3, as a true division), both left on the device."""
    sigma = prep["sigma"]
    return (map_state, prep["source"], prep["source_valid"], prep["initial_guess"], config.voxel_size_map,
            3.0 * sigma, sigma / device_constant(3.0, sigma.dtype, sigma.device), config.sem_th)


def run_icp(map_state, prep: dict, config: SageConfig, mesh=None) -> reg.IcpResult:
    """The ICP solve of prepare_icp_inputs' frame. With a mesh
    (parallel.sharding.Mesh) the GN rows are split across its ranks."""
    return reg.register_frame(
        *_icp_args(map_state, prep, config), max_iterations=config.max_icp_iterations,
        probe_depth=config.probe_depth, fast_params=_fast_params(config), tables=prep["tables"], mesh=mesh,
    )


def basic_label_mask(config: SageConfig, device, num_labels: int = 260) -> torch.Tensor:
    """(num_labels,) bool, True for the basic-class labels; built once
    per device (ops/constants.py)."""
    return device_constant([lab in config.basic_parts_labels for lab in range(num_labels)], torch.bool, device)


def odometry_step(state: OdomState, points, valid, timestamps, config: SageConfig, mesh=None,
                  shard_insert: bool = True):
    """One odometry step. points (scan_capacity, 4) sensor-frame
    xyz+label; valid (scan_capacity,); timestamps (scan_capacity,) in
    [0, 1], read only with config.deskew. Returns (new_state, pose (4, 4),
    aux, landmark_cells_dropped): the last, 0-dim int32, is the dynamic
    filter's landmark cells beyond its capacity, a drop the JAX package
    does not count (kept out of StepAux, whose fields are JAX's). The
    state is not modified (make_step's step updates its state in place).
    The host reads the ICP loop's status once per block of iterations
    (ops/registration.py) and nothing else.

    mesh (parallel.sharding.Mesh): the ranks split the per-point work (the
    scan head with deskew, the filter's pooling and query rows, the
    correspondence rows and GN, or the reference search) and, with
    shard_insert, the insert's policy rows, and end with the same state
    (parallel/sharding.py)."""
    prep = prepare_icp_inputs(state, points, valid, timestamps, config, mesh)
    icp = run_icp(state.map, prep, config, mesh)
    return finish_step(state, prep, icp, config, mesh, shard_insert)


def finish_step(state: OdomState, prep: dict, icp: reg.IcpResult, config: SageConfig, mesh=None,
                shard_insert: bool = True, in_place: bool = False):
    """Everything of the step after the ICP solve: the solve-health guard,
    the map insert and cull, the new state and the aux. Returns
    odometry_step's (new_state, pose, aux, landmark_cells_dropped).
    in_place: state.map is a donated map (a spare row behind each tensor,
    as hashmap.create and hashmap.with_spare make them), updated in
    place; the returned state's other fields are new tensors."""
    dev = icp.pose.device
    source_valid = prep["source_valid"]
    frame_ds, frame_valid = prep["frame_ds"], prep["frame_valid"]
    initial_guess = prep["initial_guess"]
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
        tables=prep["tables"], mesh=mesh if shard_insert else None, in_place=in_place,
    )
    new_map = hm.remove_far(new_map, new_pose[:3, 3], config.local_map_range, in_place=in_place)

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
        icp_iterations=icp.iterations,
        num_correspondences=icp.num_correspondences,
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
    return new_state, new_pose, aux, prep["lmk_dropped"]


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
    poses (W, 4, 4) on the device, per-frame ICP iterations ((W,) int32 on
    the device), aux aggregated over the chunk: drop counters summed,
    occupancy maxed, sigma/iterations/correspondences of the last frame),
    landmark cells dropped over the chunk. The W steps are the
    single-frame steps in order, on one upload (sharded on `mesh` when
    given)."""
    poses, iters, agg, lmk_dropped = [], [], None, 0
    for pts in scans:
        p, valid, ts = _split_packed(pts)
        state, pose, aux, lmk = odometry_step(state, p, valid, ts, config, mesh)
        poses.append(pose)
        iters.append(aux.icp_iterations)
        agg = _fold_aux(agg, aux)
        lmk_dropped = lmk_dropped + lmk
    return state, torch.stack(poses), torch.stack(iters), agg, lmk_dropped


def resolve_device(device=None) -> torch.device:
    """None means the card. Without one, only an explicit "cpu" runs:
    the port never falls back to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to run on the CPU')
    return device


def _small_fields(state: OdomState) -> list:
    """The state's tensors other than the map, in a fixed order."""
    return [state.last_pose, state.prev_pose, state.first_pose, state.num_poses, *state.threshold,
            state.reject_streak]


def _take(state: OdomState, device, donate: bool) -> OdomState:
    """A step's own state from the caller's `state`. With donate, each
    tensor already on `device` (a map tensor with hashmap's spare row
    behind it) whose storage no other field shares is taken as it is;
    every other tensor is copied."""
    taken = set()

    def own(t, map_tensor: bool):
        if t is None:
            return None
        moved = t.to(device)
        key = moved.untyped_storage().data_ptr()
        if donate and moved is t and key not in taken and (not map_tensor or hm.has_spare(t)):
            taken.add(key)
            return t
        return hm.with_spare(moved) if map_tensor else moved.clone()

    small = [own(t, False) for t in _small_fields(state)]
    return OdomState(hm.MapState(*[own(t, True) for t in state.map]), *small[:4], ThresholdState(*small[4:7]),
                     small[7])


def _zero_aux(device) -> StepAux:
    return StepAux(*[torch.zeros((), dtype=torch.float32 if f == "sigma" else torch.int32, device=device)
                     for f in StepAux._fields])


def _fold_into(totals: StepAux, aux: StepAux) -> None:
    """_fold_aux in place on zero-started totals (the same values: every
    occupancy stat is >= 0)."""
    for t, v in zip(totals, _fold_aux(totals, aux)):
        t.copy_(v)


def _capture_graph(fn, stream: torch.cuda.Stream) -> torch.cuda.CUDAGraph:
    """fn's launches, captured on `stream` (run by replay()). The stream is
    the step's own: torch.cuda.graph's default capture stream is made
    once a process, on the device current then, and a capture on that
    stream would switch to its device. The capture refuses unsafe calls
    from this thread only ("thread_local"): ProcessGroupNCCL's watchdog
    thread queries its events meanwhile, which a "global" capture would
    count against the graph."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        fn()
    return graph


# the step's and SageICP's spans (runtime/tracing.py), bound once
_SPANS = {name: tracing.span(name) for name in ("upload", "pad", "wait.pose", "trajectory", "reinitialize",
                                                  "launch.prepare", "launch.block", "launch.reanchor",
                                                  "launch.finish")}
_CALL_SPANS = {name: tracing.RECORDER.span(name, opens_frame=True) for name in ("frame", "chunk")}


def on_device(device):
    """The context that makes `device` current for the kernels' launches
    (cuda_lib.call): torch.cuda.device for a card, nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class DeviceStep:
    """The device-resident odometry step behind make_step,
    make_step_packed, make_chunk_step and SageICP on one device.

    The state lives in the step's own buffers and is updated in place
    (each map tensor with a spare row behind it: hashmap.with_spare).
    donate=True (the JAX step's donate_argnums): the first state it is
    given becomes its own where it can, each tensor already on the device (a map tensor with
    hashmap's spare row behind it, as hashmap.create makes them) taken
    as it is and updated in place, the others copied; donate=False
    copies that state in and never writes to the caller's tensors. A
    later state the step did not return is copied in. The frame's inputs
    are copied into fixed input buffers, and the ICP loop stays on the
    device (registration.IcpLoop, or RefLoop without fast
    correspondences): the host reads its status once per block of
    iterations and nothing else.

    graph=True (a CUDA device): the first call runs the frame eagerly on
    a side stream, which builds the kernels, their scratch and every
    constant (and, on a mesh, NCCL's communicator); then the pieces are
    captured as CUDA graphs and replayed on every later frame:
        prepare   preprocess, filter, deskew, downsample, threshold,
                  prediction, probe tables, the first row setup and the
                  first block of ICP iterations;
        block     a block of ICP iterations;
        reanchor  the rows rebuilt at the current pose, then a block
                  (the frozen-rows loop only);
        finish    guard, renormalize, insert, cull, the state, the aux
                  and the running totals.
    A failed capture raises; nothing falls back. graph=False runs the same
    pieces eagerly (the counterpart of jit=False), on any device. Every
    call runs with the step's device current.

    mesh (parallel.sharding.Mesh): the per-point work and, with
    shard_insert, the insert's policy rows are split across its ranks, as
    in odometry_step. Over NCCL (or in a world without a group) the
    collectives are captured with the rest: every rank replays the same
    graphs in the same order, since the summed GN terms, and so the
    status, are the same on every rank. A gloo mesh copies through the
    host and cannot be captured: graph=True raises there. NCCL's
    communicator waits, when it is destroyed, for every graph that holds
    its kernels: release() a mesh step's graphs before
    torch.distributed.destroy_process_group.

    The returned pose, aux and totals are the step's own tensors, valid
    until the next call. Running totals (`totals`, `lmk_total`) fold every
    frame as SageICP.aux_totals does; `reset_totals` zeroes them.

    The inputs are copied into the step's own buffers without waiting
    (`loaded`, a CUDA event, is recorded after the copy on a card): a
    caller that rewrites a host input in place waits on it first.

    Every call is a frame of the recorder (runtime/tracing.py): its
    input copy is the `upload` span, its pieces the `launch.*` spans, and
    each piece stamps the device's stage clock (captured with it): prepare
    opens the frame and stamps the deskew (with its count of deskewed
    points), head, filter and downsample stages, its rest and every block
    and reanchor piece go to the icp stage (prepare's and each reanchor's
    close stamp with the frame's found pairs so far), finish to the update
    stage and, last, the frame's GN live-row count."""

    def __init__(self, config: SageConfig, device=None, graph: bool = True, packed: bool = True, mesh=None,
                 shard_insert: bool = True, donate: bool = True):
        self.config = config
        if graph and mesh is not None and not mesh.captures:
            raise ValueError(f"graph=True captures the step's collectives on a card over NCCL; a mesh on "
                             f"{mesh.device} over the {mesh.backend} backend cannot be captured (gloo copies "
                             "through the host): pass graph=False")
        self.device = resolve_device(device)
        self.mesh, self.shard_insert = mesh, shard_insert
        if graph and self.device.type != "cuda":
            raise ValueError(f"graph=True captures CUDA graphs and needs a CUDA device, not {self.device}: "
                             "pass graph=False")
        self.fast_params = _fast_params(config)
        self.graph, self.packed, self.donate = graph, packed, donate
        geo.pin_full_fp32()
        self.clock = tracing.StageClock(tracing.RECORDER, self.device)
        self.state: OdomState | None = None
        self._input: list | None = None
        self.loaded: torch.cuda.Event | None = None  # recorded after the last input copy (on a card)
        self._graphs: dict | None = None
        self.totals, self.chunk_totals = _zero_aux(self.device), _zero_aux(self.device)
        self.lmk_total = torch.zeros((), dtype=torch.int32, device=self.device)
        self.chunk_lmk = torch.zeros((), dtype=torch.int32, device=self.device)

    def reset_totals(self) -> None:
        torch._foreach_zero_([*self.totals, self.lmk_total])

    def release(self) -> None:
        """Drop the captured graphs; the next call captures anew."""
        self._graphs = None

    def _adopt(self, state: OdomState) -> None:
        if state is self.state:
            return
        if self.state is None:
            self.state = _take(state, self.device, self.donate)
            return
        hm.copy_into(self.state.map, state.map)
        for d, s in zip(_small_fields(self.state), _small_fields(state)):
            d.copy_(s)

    def _load(self, inputs) -> None:
        """The inputs copied into the step's own, without waiting on the
        card (from pinned memory the copy runs behind the host); `loaded`
        is recorded after them."""
        if self._input is None:
            self._input = [torch.empty(x.shape, dtype=x.dtype, device=self.device) for x in inputs]
        with _SPANS["upload"]:
            for d, x in zip(self._input, inputs):
                if x.shape != d.shape or x.dtype != d.dtype:
                    raise ValueError(f"the step's input is {tuple(d.shape)} {d.dtype}, got {tuple(x.shape)} "
                                     f"{x.dtype}")
                d.copy_(x, non_blocking=True)
            if self.device.type == "cuda":
                self.loaded = torch.cuda.Event()
                self.loaded.record()

    def _prepare(self) -> None:
        cfg, clock = self.config, self.clock
        clock.begin()
        pts, valid, ts = _split_packed(self._input[0]) if self.packed else self._input
        self._prep = prep = prepare_icp_inputs(self.state, pts, valid, ts, cfg, self.mesh, clock.split)
        args = _icp_args(self.state.map, prep, cfg)
        if self.fast_params is None:
            self._loop = reg.RefLoop(*args, cfg.max_icp_iterations, cfg.probe_depth, self.mesh)
        else:
            self._loop = reg.IcpLoop(*args, cfg.max_icp_iterations, cfg.probe_depth, self.fast_params,
                                     prep["tables"], self.mesh)
        self._loop.block()
        self._close_icp()

    def _close_icp(self) -> None:
        """The stamp that closes an icp piece; the frozen-rows loop's
        copies its found pairs so far into the row's corr_found_pairs."""
        if self.fast_params is None:
            self.clock.close(tracing.ICP)
        else:
            self.clock.close(tracing.ICP, self._loop.found_pairs, tracing.CORR_FOUND_PAIRS)

    def _block(self) -> None:
        self.clock.start()
        self._loop.block()
        self.clock.close(tracing.ICP)

    def _reanchor(self) -> None:
        self.clock.start()
        self._loop.reanchor()
        self._loop.block()
        self._close_icp()

    def _finish(self) -> None:
        self.clock.start()
        icp = self._loop.result()
        new, pose, aux, lmk = finish_step(self.state, self._prep, icp, self.config, self.mesh, self.shard_insert,
                                          in_place=True)
        for d, s in zip(_small_fields(self.state), _small_fields(new)):
            d.copy_(s)
        _fold_into(self.totals, aux)
        _fold_into(self.chunk_totals, aux)
        self.lmk_total.add_(lmk)
        self.chunk_lmk.add_(lmk)
        self._out = (pose, aux, lmk)
        self.clock.end_frame(tracing.UPDATE, self._loop.loop_i[ik.I_LIVE_ROWS])

    def _piece(self, name: str) -> None:
        """The captured piece `name` replayed, or run eagerly before the
        captures and without graphs."""
        with _SPANS["launch." + name]:
            if self._graphs is not None:
                self._graphs[name].replay()
            else:
                getattr(self, "_" + name)()

    def _run(self) -> None:
        """The frame: prepare, blocks (and re-anchors) until the loop is
        done with one status read per block, finish."""
        self._piece("prepare")
        while (s := self._loop.status()) != ik.DONE:
            self._piece("reanchor" if s == ik.REANCHOR else "block")
        self._piece("finish")
        tracing.RECORDER.close_frame()

    def _capture(self) -> tuple:
        """The first frame, eagerly on a side stream; then the captures.
        Returns the first frame's outputs."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._run()
        main.wait_stream(side)
        out = self._out
        graphs = {"prepare": _capture_graph(self._prepare, side)}
        graphs["block"] = _capture_graph(self._block, side)
        if self.fast_params is not None:
            graphs["reanchor"] = _capture_graph(self._reanchor, side)
        graphs["finish"] = _capture_graph(self._finish, side)
        self._graphs = graphs
        return out

    def __call__(self, state: OdomState, *inputs):
        """(state, inputs...) -> (state, pose, aux, landmark_cells_dropped)."""
        with on_device(self.device):
            tracing.RECORDER.begin_frame(self.clock)
            try:
                self._adopt(state)
                self._load(inputs)
                if self.graph and self._graphs is None:
                    out = self._capture()
                else:
                    self._run()
                    out = self._out
            finally:
                tracing.RECORDER.end_frame()
        return (self.state, *out)

    def chunk(self, state: OdomState, scans: torch.Tensor):
        """W packed frames (W, cap, 4|5) -> (state, poses (W, 4, 4),
        iterations (W,) int32, the chunk's aggregated aux, its landmark
        cells dropped), chunk_step's values."""
        W = scans.shape[0]
        poses = torch.empty((W, 4, 4), dtype=torch.float32, device=self.device)
        iters = torch.empty((W,), dtype=torch.int32, device=self.device)
        torch._foreach_zero_([*self.chunk_totals, self.chunk_lmk])
        for w in range(W):
            state, pose, aux, _ = self(state, scans[w])
            poses[w].copy_(pose)
            iters[w].copy_(aux.icp_iterations)
        return state, poses, iters, self.chunk_totals, self.chunk_lmk


def make_step(config: SageConfig, graph: bool = True, device=None, donate: bool = True) -> DeviceStep:
    """The device-resident step: step(state, points, valid, timestamps)
    -> (state', pose, aux, landmark_cells_dropped), odometry_step's values,
    with the state updated in place (DeviceStep). graph=True captures it
    as CUDA graphs (a CUDA device only; on the CPU it raises), graph=False
    runs it eagerly: the counterparts of the JAX package's jit=True and
    jit=False. donate=True updates the caller's state in place, as JAX's
    donated step consumes it; donate=False leaves it untouched."""
    return DeviceStep(config, device, graph, packed=False, donate=donate)


def make_step_packed(config: SageConfig, graph: bool = True, device=None, donate: bool = True) -> DeviceStep:
    """make_step from one packed (scan_capacity, 4|5) buffer, float32 or
    int16 (pad_chunk's rows): step(state, packed) -> (state', pose, aux,
    landmark_cells_dropped)."""
    return DeviceStep(config, device, graph, packed=True, donate=donate)


def make_chunk_step(config: SageConfig, chunk: int, graph: bool = True, device=None):
    """step(state, scans (chunk, scan_capacity, 4|5)) -> (state', poses
    (chunk, 4, 4), iterations (chunk,) int32, aux aggregated over the
    chunk as chunk_step does (the last frame's sigma, iterations and
    correspondences, occupancy maxed, counters summed), landmark cells
    dropped over the chunk), on make_step_packed's step."""
    step = DeviceStep(config, device, graph, packed=True)

    def run(state: OdomState, scans: torch.Tensor):
        if scans.shape[0] != chunk:
            raise ValueError(f"a chunk step of {chunk} frames got {scans.shape[0]}")
        return step.chunk(state, scans)

    return run


class _Staging:
    """SageICP's host buffer for chunks of W scans (W, scan_capacity,
    lanes), made once and filled with the pad sentinel: pinned when the
    step is on a card. `array` is its numpy view and, for float32,
    `points` the view of each row's first four lanes as one 16-byte
    element. `rows` holds each slot's scan rows as last written (the rows
    past them hold the sentinel), `uploaded` the CUDA event recorded after
    the last copy out of it (None: nothing to wait for), `device`
    register_chunk's device buffer of the same shape."""

    __slots__ = ("host", "array", "points", "rows", "uploaded", "device")

    def __init__(self, shape: tuple, dtype: torch.dtype, sentinel, pin: bool):
        self.host = torch.full(shape, sentinel, dtype=dtype, pin_memory=pin)
        self.array = self.host.numpy()
        if dtype == torch.float32:
            W, cap, lanes = shape
            self.points = np.ndarray((W, cap), "V16", buffer=self.array, strides=(cap * lanes * 4, lanes * 4))
        self.rows = [0] * shape[0]
        self.uploaded: torch.cuda.Event | None = None
        self.device: torch.Tensor | None = None


class SageICP:
    """Stateful wrapper: pads scans to the fixed capacity, steps the
    pipeline on `device` (default the card) and keeps the trajectory and
    running totals of the per-frame counters (no per-frame aux log).

    Scans are staged in a host buffer of the SageICP's own, one for each
    chunk length, reused from call to call (pinned on the card, so the
    uploads run behind the host): pad_chunk's result is that buffer.

    It runs the device-resident step (DeviceStep): captured as CUDA graphs
    on the card (graph=None or True), eager on the CPU (graph=None or
    False), with either ICP branch; graph=True on the CPU raises. With a
    mesh (parallel.sharding.Mesh; ShardedSageICP passes one) the step is
    sharded.

    The recorder (runtime/tracing.py) holds each frame's record: its host
    spans (`frame` or `chunk`, `pad`, `upload`, `launch.*`, `wait.*`), its
    device stage times and its GN live rows; `drive` is the recorder's
    drive this SageICP is on (a new one at every reinitialize)."""

    def __init__(self, config: SageConfig | str = "kitti", device=None, graph: bool | None = None, mesh=None):
        if isinstance(config, str):
            config = PRESETS[config]
        self.config = config
        self.device = resolve_device(device)
        if graph is None:
            graph = self.device.type == "cuda"
        self.graph, self.mesh = bool(graph), mesh
        geo.pin_full_fp32()
        self._step = DeviceStep(self.config, self.device, self.graph, packed=True, mesh=mesh)
        self._staging: dict = {}  # (W, lanes, dtype) -> _Staging
        self._staged: _Staging | None = None  # the buffer pad_chunk wrote last
        self.reinitialize()

    def reinitialize(self):
        """Empty map, empty trajectory (reference sageICP.hpp:94-99); a new
        drive of the recorder."""
        self.drive = tracing.RECORDER.new_drive()
        with _SPANS["reinitialize"]:
            self.state = init_state(self.config, self.device)
            self.poses: list = []  # (4, 4) numpy, or device tensors (4, 4) / (W, 4, 4)
            self._iters: list = []  # per-frame iterations, (n,) int32 device tensors
            self._last_aux = None
            self._step.reset_totals()

    def release(self) -> None:
        """Drop the step's captured graphs (DeviceStep.release): before
        destroy_process_group on a mesh of NCCL ranks."""
        self._step.release()

    def pad_chunk(self, scans: list, timestamps: list | None = None) -> np.ndarray:
        """(W, scan_capacity, 4|5) packed host buffer: float32 rows padded
        with INVALID_COORD, or int16 (quantized_scan_upload) padded with
        QSCAN_INVALID. With deskew on, lane 4 holds per-point timestamps
        (given, or the azimuth phase).

        The buffer is this SageICP's staging buffer for W scans (made at
        the first call with W, pinned on the card) and its next pad_chunk
        of W scans overwrites it: copy it to keep it. Only the rows that
        change are written: each scan's own, and the sentinel over the rows
        its slot's previous scan held beyond them. The `pad` span, with the
        recorder's staging counts; waiting for the buffer's last upload to
        leave it is an `upload` span."""
        cfg = self.config
        cap = cfg.scan_capacity
        lanes = 5 if cfg.deskew else 4
        quantized = cfg.quantized_scan_upload
        dtype, sentinel = (torch.int16, QSCAN_INVALID) if quantized else (torch.float32, scan_ops.INVALID_COORD)
        key = (len(scans), lanes, dtype)
        st = self._staging.get(key)
        if st is not None and st.uploaded is not None and not st.uploaded.query():
            with _SPANS["upload"]:
                st.uploaded.synchronize()
        with _SPANS["pad"]:
            made = st is None
            if made:
                st = self._staging[key] = _Staging((len(scans), cap, lanes), dtype, sentinel,
                                                   self.device.type == "cuda")
            staged = 0
            for i, s in enumerate(scans):
                n = min(len(s), cap)
                rows = np.ascontiguousarray(s[:n, :4], dtype=np.float32)
                ts = None
                if lanes == 5:
                    ts = timestamps[i] if timestamps is not None else None
                    ts = azimuth_timestamps(rows[:, :3]) if ts is None else ts[:n]
                    ts = np.asarray(ts, np.float32)
                if quantized:
                    _quantize_scan_host(rows if ts is None else np.concatenate([rows, ts[:, None]], axis=1),
                                        st.array[i])
                else:
                    # one thread (numpy): torch's copy over the intra-op threads waits, after a wait on
                    # the card, for them to wake, which lengthened a streamed frame's tail
                    st.points[i, :n] = rows.view("V16")[:, 0]
                    if ts is not None:
                        st.array[i, :n, 4] = ts
                if n < st.rows[i]:
                    st.array[i, n:st.rows[i]] = sentinel
                st.rows[i] = n
                staged += n
            self._staged = st
            tracing.RECORDER.count_staging(staged, int(made))
        return st.array

    def _upload_chunk(self) -> torch.Tensor:
        """register_chunk's copy of the staging buffer pad_chunk filled last
        to the card, into its device twin (made at its first chunk), without
        waiting; the staging buffer's `uploaded` is recorded after it. On
        the CPU the buffer is stepped as it is. The `upload` span."""
        st = self._staged
        with _SPANS["upload"]:
            if self.device.type != "cuda":
                return st.host
            if st.device is None:
                st.device = torch.empty(st.host.shape, dtype=st.host.dtype, device=self.device)
                tracing.RECORDER.count_staging(0, 1)
            st.device.copy_(st.host, non_blocking=True)
            st.uploaded = torch.cuda.Event()
            st.uploaded.record()
            return st.device

    def _record(self, aux: StepAux, iters: torch.Tensor) -> None:
        """After a step: the last call's aux and the per-frame iterations
        (the step keeps the running totals)."""
        self._last_aux = aux
        self._iters.append(iters.reshape(-1))

    def register_frame(self, points: np.ndarray, timestamps: np.ndarray | None = None,
                       block: bool = True):
        """points (n, 4) float xyz+label -> the 4x4 pose. timestamps (n,)
        in [0, 1] are used with deskew on; without them the azimuth phase
        stands in. block=False returns the pose as a device tensor without
        waiting; trajectory() fetches it. The `frame` span."""
        with _CALL_SPANS["frame"]:
            buf = self.pad_chunk([points], None if timestamps is None else [timestamps])[0]
            self.state, pose, aux, _ = self._step(self.state, torch.from_numpy(buf))
            if self._staged is not None:
                self._staged.uploaded = self._step.loaded
            self._record(aux, aux.icp_iterations.clone())
            if block:
                with _SPANS["wait.pose"]:
                    pose = pose.cpu().numpy()
            else:
                pose = pose.clone()
            self.poses.append(pose)
        return pose

    def register_chunk(self, scans: list, timestamps: list | None = None) -> torch.Tensor:
        """Offline mode: W frames on one upload (chunk_step). scans: a list
        of W (n, 4) arrays, staged by pad_chunk and copied without waiting
        into a device buffer kept for the next chunk of W; an array or a
        tensor raises TypeError. Appends the (W, 4, 4) device poses to the
        trajectory and returns them without waiting. The `chunk` span."""
        if not isinstance(scans, list):
            raise TypeError(f"register_chunk takes a list of (n, 4) scans, not a {type(scans).__name__}")
        with _CALL_SPANS["chunk"]:
            self.pad_chunk(scans, timestamps)
            self.state, poses, iters, aux, _ = self._step.chunk(self.state, self._upload_chunk())
            self._record(aux, iters)
            self.poses.append(poses)
        return poses

    @property
    def icp_iters(self) -> list[int]:
        """Per-frame ICP iteration counts, fetched in one transfer."""
        if not self._iters:
            return []
        return torch.cat(self._iters).tolist()

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
        return StepAux(*[np.asarray(a.cpu()) for a in self._step.totals])

    def landmark_cells_dropped(self) -> int:
        """Landmark cells the dynamic filter dropped beyond its capacity,
        summed over every frame since the last reinitialize (a silent drop
        of the JAX package, counted here outside StepAux)."""
        return int(self._step.lmk_total)

    def trajectory(self) -> np.ndarray:
        """(N, 4, 4) poses; the poses held on the device come over in one
        transfer. The `trajectory` span."""
        if not self.poses:
            return np.zeros((0, 4, 4))
        with _SPANS["trajectory"]:
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
