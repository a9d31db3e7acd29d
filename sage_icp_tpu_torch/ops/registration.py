"""Point-to-point ICP with Gauss-Newton steps and a Geman-McClure robust
weight, as in the reference's registration core:

  * residual r = s - t, Jacobian J = [I | -hat(s)]
  * weight w = kernel^2 / (kernel + ||r||^2)^2
  * solve (J^T W J) x = -(J^T W r), increment = SE3::exp(x)
  * at most 500 iterations, stop when ||x|| < 1e-4
  * empty map: the initial guess comes back unchanged

The frozen-rows loop (fast_params given, the main path) stays on the
device, as the JAX package's lax.while_loop does. Its state is two small
device tensors (ops/icp_kernel.py): the anchor, T_icp, the iteration and
correspondence counts, the last |x|, the drift and a status word. An
iteration is two launches that read and write only that state: the fused
GN kernel (nn_kernels.fused_gn_iteration) and the step kernel
(icp_kernel.icp_step: the solve, the pose update and the tests). The
host queues them in blocks of BLOCK_ITERATIONS and reads the status once
after each block; a stopped loop turns the rest of a block into no-op
launches, so max_iterations holds exactly and the iteration and
correspondence counts are those of a loop that tests every iteration.
When the status asks for a re-anchor, the rows are rebuilt between two
blocks, at T_icp @ anchor, on the device. Each row build counts its live
rows (a used query slot) on the device, and each running step adds that
count to the frame's live rows, the GN rows the loop ran
(frozen_rows' live_rows; runtime/tracing.py reads it). Each row build also
adds its found (row, neighbour) pairs to the loop's found_pairs
(correspondence_fast.candidate_planes). IcpLoop exposes the pieces
(its constructor, block, reanchor, result; status between them) that a
captured step (models/pipeline.py::DeviceStep) records as CUDA graphs.

The reference-shaped branch (fast_params=None, RefLoop) stays on the
device too, as the JAX package's second lax.while_loop does: an iteration
is the search (hashmap.get_correspondences), build_normal_equations, the
step kernel's reference mode (icp_kernel.icp_ref_step: the solve, the pose
update and the exit test) and the source update by the step's increment,
queued in blocks of REF_BLOCK_ITERATIONS with one status read a block. A
stopped loop's step writes the identity as its increment, so the searches
left in a block change nothing. Given the step's stage clock, each search
is the `search` stage between two stamps, and the stamp after it copies
the loop's running search counts (`searched`: sources, found pairs,
candidates, added for a running loop only) into the frame's row
(runtime/tracing.py).

Across the ranks of a mesh (parallel/sharding.py) each rank builds only
its contiguous share of the frozen rows (corr_setup's `rows`: the query
sort and the seats stay whole on every rank, the candidate gathers are
the share's) and runs the GN kernel on it; the (18,) sums are
all-gathered as an (n, 18) buffer and added in rank order on the device,
the same on every rank, so every rank takes the same steps and reads the
same status. The reference branch splits its sources the same way and
gathers its normal equations (RefLoop). Nothing of that reads the host,
so a captured step records the gathers with the rest (over NCCL).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sage_icp_tpu_torch.ops import correspondence_fast as cf
from sage_icp_tpu_torch.ops import geometry as geo
from sage_icp_tpu_torch.ops import hashmap as hm
from sage_icp_tpu_torch.ops import icp_kernel as ik
from sage_icp_tpu_torch.ops import nn_kernels
from sage_icp_tpu_torch.ops.constants import device_scalar
from sage_icp_tpu_torch.ops.scan import trunc_div
from sage_icp_tpu_torch.runtime import tracing

MAX_ITERATIONS = 500

# GN iterations queued per status read. Bench frames take 4.4 (city) and
# 4.9 (kitti) iterations on average, 3-8 in steady driving, so most frames
# end inside their first block: one host read a frame, and the rest of the
# block is no-op launches of a few microseconds each. A block is
# BLOCK_ITERATIONS GN launches and as many step launches, so the blocks a
# run took are its icp_step launches (cuda_lib.launches) over this.
BLOCK_ITERATIONS = 8
# The reference-shaped loop's iterations per status read (RefLoop.block):
# each is a whole search (3.74-3.76 device ms at the kitti preset on an
# H100 80GB HBM3 at 700 W), and those left in a block after convergence
# run for nothing, while a status read costs a host round trip (tens of
# microseconds). chip_smoke.py phase 15 times the captured kitti drive at
# 1, 2, 4 and 8; 1 took the least there, 1.2 ms/frame less than 2
# (PERF.md).
REF_BLOCK_ITERATIONS = 1


def build_normal_equations(src, tgt, weight_mask, kernel):
    """J^T W J (6, 6) and J^T W r (6,) over the masked correspondences of
    (N, 4) src/tgt rows (label lanes ignored)."""
    s = src[:, :3]
    r = s - tgt[:, :3]
    r2 = torch.sum(r * r, dim=-1)
    w = (kernel * kernel) / torch.square(kernel + r2)
    w = torch.where(weight_mask, w, 0.0)
    n = s.shape[0]
    zeros = torch.zeros((n,), dtype=s.dtype, device=s.device)
    ones = torch.ones_like(zeros)
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    J = torch.stack([
        torch.stack([ones, zeros, zeros, zeros, sz, -sy], dim=-1),
        torch.stack([zeros, ones, zeros, -sz, zeros, sx], dim=-1),
        torch.stack([zeros, zeros, ones, sy, -sx, zeros], dim=-1),
    ], dim=1)  # (N, 3, 6)
    Jwf = (J * w[:, None, None]).reshape(n * 3, 6)
    JTJ = Jwf.T @ J.reshape(n * 3, 6)
    JTr = Jwf.T @ r.reshape(n * 3)
    return JTJ, JTr


class IcpResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) on the frame's device
    iterations: torch.Tensor  # 0-dim int32 on the frame's device
    num_correspondences: torch.Tensor  # 0-dim int32, at the last iteration
    dropped_queries: torch.Tensor  # 0-dim int32: valid sources without a row seat


class FrozenRows(NamedTuple):
    """A rank's share of a CorrSetup, as the GN kernel reads it."""

    planes: tuple  # cx, cy, cz, cl (R', M) int16
    q0: torch.Tensor  # (R', 4P) f32
    origin: torch.Tensor  # (R', 3) f32
    row_abs: torch.Tensor  # (R', 3) int32
    used: torch.Tensor  # (R', P) int32
    tile_map: torch.Tensor  # (ceil(R' / TILE_ROWS),) int32
    n_dropped: torch.Tensor  # 0-dim int32, of the whole setup


def frozen_rows(setup: cf.CorrSetup, rows: tuple[int, int] | None = None,
                live_rows: torch.Tensor | None = None) -> FrozenRows:
    """The setup's rows as the GN kernel reads them, and their tile map.
    rows (lo, hi): the setup holds only those rows of R (corr_setup's
    `rows`), whose row_rel is still every row's. Each plane is one
    contiguous block of R' rows of stride 2M, a multiple of the kernel's
    load width, so every plane base stays aligned. live_rows (a 0-dim
    int32 tensor): set to the rows with a used query slot, counted on
    the device."""
    Rl = setup.q0.shape[0]
    lo, hi = (0, Rl) if rows is None else rows
    live = setup.grid_used.any(dim=1)
    if live_rows is not None:
        torch.sum(live, dim=0, dtype=torch.int32, out=live_rows)
    used = setup.grid_used.to(torch.int32)
    return FrozenRows(
        planes=(setup.cxp, setup.cyp, setup.czp, setup.clp),
        q0=setup.q0.reshape(Rl, -1),
        origin=setup.row_origin_abs,
        row_abs=(setup.row_rel[lo:hi] + setup.center[None, :]),
        used=used,
        tile_map=nn_kernels.default_tile_map(used, live),
        n_dropped=setup.n_dropped,
    )


class IcpLoop:
    """The frozen-rows ICP loop of one frame, in pieces that launch work
    on the device and never read it back, apart from `status`:

        loop = IcpLoop(...)        # state at the initial guess, the rows
        loop.block()               # BLOCK_ITERATIONS x (GN, step)
        while (s := loop.status()) != icp_kernel.DONE:
            if s == icp_kernel.REANCHOR:
                loop.reanchor()    # rows rebuilt at T_icp @ anchor
            loop.block()
        loop.result()

    The state (loop_f, loop_i) and the rows keep their storage from the
    constructor on: reanchor writes the new rows into it, so a CUDA graph
    captured over block() replays against whatever rows are current.
    found_pairs (0-dim int32) sums the found (row, neighbour) pairs of
    every row build of the loop."""

    def __init__(self, map_state: hm.MapState, frame, valid, initial_guess, voxel_size,
                 max_correspondence_distance, kernel, sem_th, max_iterations: int, probe_depth: int,
                 fast_params: dict, tables=None, mesh=None):
        dev = frame.device
        self.map_state, self.frame, self.valid = map_state, frame, valid
        self.voxel_size, self.sem_th, self.probe_depth = voxel_size, sem_th, probe_depth
        self.fast_params, self.mesh = fast_params, mesh
        self.max_iterations = int(max_iterations)
        self.drift_lim = float(np.float32(0.45 * voxel_size))
        guess = initial_guess.to(device=dev, dtype=torch.float32)
        if tables is None:
            tables = cf.build_probe_tables(map_state, trunc_div(guess[:3, 3], voxel_size), probe_depth)
        self.tables = tables
        K = map_state.points_per_voxel
        self.offs = cf.lane_offsets(K, voxel_size, dev)
        self.scale = voxel_size / hm.QSCALE
        r2 = torch.sum(frame[:, :3] * frame[:, :3], dim=-1)
        r_scan = torch.sqrt(torch.max(torch.where(valid, r2, 0.0)))
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        self.loop_f = torch.cat([
            guess.reshape(-1), eye.reshape(-1), *(device_scalar(v, torch.float32, dev).reshape(1)
                                                  for v in (max_correspondence_distance, kernel)),
            torch.full((1,), float("inf"), device=dev), torch.zeros((1,), device=dev), r_scan.reshape(1),
            torch.zeros((ik.LOOP_F - ik.F_R_SCAN - 1,), device=dev),
        ])
        self.loop_i = torch.zeros((ik.LOOP_I,), dtype=torch.int32, device=dev)
        if self.max_iterations <= 0:
            self.loop_i[ik.I_STATUS].fill_(ik.DONE)
        self.found_pairs = torch.zeros((), dtype=torch.int32, device=dev)
        n_rows = fast_params["unique_voxel_rows"] + fast_params["overflow_rows"]
        self.row_span = None if mesh is None else mesh.row_range(n_rows)
        self.rows = self._rows_at(guess)

    def _rows_at(self, pose) -> FrozenRows:
        """This rank's frozen rows with the queries at `pose`; their live
        rows counted into the loop's state (icp_kernel.I_ROWS), their found
        pairs added to found_pairs."""
        setup = cf.corr_setup(self.map_state, self.tables, geo.transform_points(pose, self.frame), self.valid,
                              self.voxel_size, self.probe_depth, **self.fast_params, rows=self.row_span,
                              found_pairs=self.found_pairs)
        return frozen_rows(setup, self.row_span, self.loop_i[ik.I_ROWS])

    def _sums(self) -> torch.Tensor:
        f, rows = self.loop_f, self.rows
        sums = nn_kernels.fused_gn_iteration(
            *rows.planes, *self.offs, rows.q0, rows.origin, rows.row_abs, rows.used,
            f[ik.F_T].view(4, 4), self.sem_th, self.scale, self.voxel_size, f[ik.F_MAX_CORR], f[ik.F_KERNEL],
            tile_map=rows.tile_map, status=self.loop_i[ik.I_STATUS],
        )
        if self.mesh is None:
            return sums
        parts = self.mesh.all_gather(sums[None])  # (n, 18)
        total = parts[0]
        for part in parts[1:]:  # rank order, the same on every rank
            total = total + part
        return total

    def block(self) -> None:
        """BLOCK_ITERATIONS iterations, each a GN launch and a step launch
        (no-ops once the status is not RUNNING)."""
        for _ in range(BLOCK_ITERATIONS):
            ik.icp_step(self._sums(), self.loop_f, self.loop_i, self.max_iterations, self.drift_lim)

    def reanchor(self) -> None:
        """anchor <- T_icp @ anchor, T_icp <- I, the rows rebuilt there
        (written into the current rows' storage), status RUNNING."""
        f = self.loop_f
        anchor = ik.compose(f[ik.F_T].view(4, 4), f[ik.F_ANCHOR].view(4, 4))
        f[ik.F_ANCHOR].copy_(anchor.reshape(-1))
        f[ik.F_T].copy_(torch.eye(4, dtype=torch.float32, device=f.device).reshape(-1))
        self.loop_i[ik.I_STATUS].zero_()
        new = self._rows_at(anchor)
        for dst, src in zip(self.rows.planes + self.rows[1:], new.planes + new[1:]):
            dst.copy_(src)

    def status(self) -> int:
        return read_status(self.loop_i)

    def result(self) -> IcpResult:
        f = self.loop_f
        return IcpResult(pose=ik.compose(f[ik.F_T].view(4, 4), f[ik.F_ANCHOR].view(4, 4)),
                         iterations=self.loop_i[ik.I_ITERATIONS], num_correspondences=self.loop_i[ik.I_NCORR],
                         dropped_queries=self.rows.n_dropped)

    def run(self) -> IcpResult:
        """The whole loop, eagerly."""
        self.block()
        while (s := self.status()) != ik.DONE:
            if s == ik.REANCHOR:
                self.reanchor()
            self.block()
        return self.result()


class RefLoop:
    """The reference-shaped ICP loop of one frame (fast_params=None), in
    IcpLoop's pieces: the constructor (the state at the initial guess, the
    source placed there), block (REF_BLOCK_ITERATIONS x (search, normal
    equations, icp_ref_step launch, source update)), status (the one
    read a block) and result. The source and the state keep their
    storage from the constructor on, so a CUDA graph captured over
    block() replays against them.

    mesh (parallel.sharding.Mesh): each rank keeps its contiguous share
    of the N sources (row_range), searches and builds the normal
    equations on it, and transforms only it; the (6, 6) and (6,) terms
    and the accepted count are all-gathered as one (n, 43) float32 buffer
    and added in rank order on the device, the same on every rank, so
    every rank takes the same step and reads the same status. Counts stay
    exact in float32 (N < 2^24).

    stamp: the step's stage clock (tracing.StageClock.split). It ends the
    `icp` stage before each search and the `search` stage after it, with
    `searched` (int64 (3,): the valid sources, found (source, neighbour
    voxel) pairs and their blocks' live points of the loop's searches so
    far, hashmap.get_correspondences' counts added while the status on the
    device is RUNNING, so a block's searches after the loop stopped count
    nothing) copied into the frame's row. On a mesh each rank counts its
    own share. Without a clock nothing is counted (`searched` is None)."""

    def __init__(self, map_state: hm.MapState, frame, valid, initial_guess, voxel_size,
                 max_correspondence_distance, kernel, sem_th, max_iterations: int, probe_depth: int,
                 mesh=None, stamp=None):
        dev = frame.device
        if mesh is not None:
            lo, hi = mesh.row_range(frame.shape[0])
            frame, valid = frame[lo:hi], valid[lo:hi]
        self.map_state, self.valid, self.mesh, self.stamp = map_state, valid, mesh, stamp
        self.voxel_size, self.sem_th, self.probe_depth = voxel_size, sem_th, probe_depth
        self.max_iterations = int(max_iterations)
        self.max_corr = device_scalar(max_correspondence_distance, torch.float32, dev)
        self.kernel = device_scalar(kernel, torch.float32, dev)
        guess = initial_guess.to(device=dev, dtype=torch.float32)
        self.source = geo.transform_points(guess, frame)
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        self.loop_f = torch.cat([guess.reshape(-1), eye.reshape(-1),
                                 torch.zeros((ik.LOOP_F - 32,), device=dev)])
        self.loop_i = torch.zeros((ik.LOOP_I,), dtype=torch.int32, device=dev)
        if self.max_iterations <= 0:
            self.loop_i[ik.I_STATUS].fill_(ik.DONE)
        self.searched = None if stamp is None else torch.zeros((3,), dtype=torch.int64, device=dev)

    def block(self) -> None:
        """REF_BLOCK_ITERATIONS iterations of the JAX loop body; once the
        status is not RUNNING, each step writes the identity as its
        increment and the source stays as it is."""
        f = self.loop_f
        for _ in range(REF_BLOCK_ITERATIONS):
            tgt, accept = self._search()
            JTJ, JTr = build_normal_equations(self.source, tgt, accept, self.kernel)
            ncorr = accept.sum(dtype=torch.int32)
            if self.mesh is not None:
                JTJ, JTr, ncorr = self._summed(JTJ, JTr, ncorr)
            ik.icp_ref_step(JTJ, JTr, ncorr, f, self.loop_i, self.max_iterations)
            self.source.copy_(geo.transform_points(f[ik.F_EST].view(4, 4), self.source))

    def _search(self):
        """One search of the sources: (target, accept). With a clock it is
        the `search` stage, and its counts are added to `searched` while
        the loop runs."""
        if self.stamp is not None:
            self.stamp(tracing.ICP)
        tgt, accept, counts = hm.get_correspondences(self.map_state, self.source, self.valid, self.voxel_size,
                                                     self.max_corr, self.sem_th, self.probe_depth)
        if self.stamp is not None:
            self.searched.add_(counts * (self.loop_i[ik.I_STATUS] == ik.RUNNING))
            self.stamp(tracing.SEARCH, self.searched, tracing.SEARCH_SOURCES)
        return tgt, accept

    def _summed(self, JTJ, JTr, ncorr):
        """Every rank's terms and count, added in rank order."""
        parts = self.mesh.all_gather(torch.cat([JTJ.reshape(36), JTr, ncorr.to(torch.float32)[None]])[None])
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total[:36].reshape(6, 6), total[36:42], total[42].to(torch.int32)

    def status(self) -> int:
        return read_status(self.loop_i)

    def result(self) -> IcpResult:
        f = self.loop_f
        return IcpResult(pose=ik.compose(f[ik.F_T].view(4, 4), f[ik.F_ANCHOR].view(4, 4)),
                         iterations=self.loop_i[ik.I_ITERATIONS], num_correspondences=self.loop_i[ik.I_NCORR],
                         dropped_queries=torch.zeros((), dtype=torch.int32, device=f.device))

    def run(self) -> IcpResult:
        """The whole loop, eagerly."""
        self.block()
        while self.status() != ik.DONE:
            self.block()
        return self.result()


_WAIT = tracing.span("wait.status")


def read_status(loop_i: torch.Tensor) -> int:
    """A loop's status: the one read from the device, per block (the
    `wait.status` span). The copy and the event that waits for it are on
    the current stream of the status's device (the stream the loop's
    launches went to)."""
    s = loop_i[ik.I_STATUS]
    with _WAIT:
        if s.device.type == "cpu":
            return int(s)
        host = _pinned_status()
        host.copy_(s, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(s.device))
        done.synchronize()
        return int(host)


_status_host: list = []


def _pinned_status() -> torch.Tensor:
    if not _status_host:
        _status_host.append(torch.empty((), dtype=torch.int32, pin_memory=True))
    return _status_host[0]


def register_frame(map_state: hm.MapState, frame, valid, initial_guess, voxel_size,
                   max_correspondence_distance, kernel, sem_th,
                   max_iterations: int = MAX_ITERATIONS, probe_depth: int = hm.DEFAULT_PROBE_DEPTH,
                   fast_params: dict | None = None, tables=None, mesh=None) -> IcpResult:
    """Frame-to-map ICP. frame (N, 4) sensor frame, valid (N,),
    initial_guess (4, 4); max_correspondence_distance and kernel are
    numbers or 0-dim device tensors. With fast_params (unique_voxel_rows /
    queries_per_voxel / overflow_rows) the frozen-rows engine runs on the
    device (IcpLoop): rows are built at an anchor pose, every iteration is
    one fused GN kernel call and one step kernel call, and the rows are
    rebuilt at the current pose once the accumulated increment drifts
    0.45 voxel. Without, each iteration runs the reference-shaped search,
    on the device too (RefLoop).

    mesh (parallel.sharding.Mesh): the frozen rows, or the reference
    branch's sources, are split across its ranks, each summing its share
    (module docstring)."""
    if fast_params is not None:
        return IcpLoop(map_state, frame, valid, initial_guess, voxel_size, max_correspondence_distance, kernel,
                       sem_th, max_iterations, probe_depth, fast_params, tables, mesh).run()
    return RefLoop(map_state, frame, valid, initial_guess, voxel_size, max_correspondence_distance, kernel, sem_th,
                   max_iterations, probe_depth, mesh).run()
