"""Point-to-point ICP with Gauss-Newton steps and a Geman-McClure robust
weight, as in the reference's registration core:

  * residual r = s - t, Jacobian J = [I | -hat(s)]
  * weight w = kernel^2 / (kernel + ||r||^2)^2
  * solve (J^T W J) x = -(J^T W r), increment = SE3::exp(x)
  * at most 500 iterations, stop when ||x|| < 1e-4
  * empty map: the initial guess comes back unchanged

The loop runs on the host with one synchronisation per Gauss-Newton
iteration: the device computes the 18 normal-equation sums (the fused GN
kernel on the frozen rows, or the reference-shaped search), the host
fetches them, solves the 6x6 system in float32, composes the increment,
and decides whether to stop and whether to re-anchor. The JAX reference
keeps this loop on the device in a lax.while_loop; a device-side loop or
a CUDA graph that removes the per-iteration sync is queued work.

Across the ranks of a mesh (parallel/sharding.py) each rank runs the GN
kernel on its contiguous slice of the frozen rows; the (18,) sums come
back as an (n, 18) buffer and are added in rank order on the host, the
same on every rank. Every branch of the loop (the exit, the drift, the
re-anchor) reads those sums, the host pose and the replicated setup, so
every rank runs the same iterations and the same collectives.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sage_icp_tpu_torch.ops import correspondence_fast as cf
from sage_icp_tpu_torch.ops import geometry as geo
from sage_icp_tpu_torch.ops import hashmap as hm
from sage_icp_tpu_torch.ops import nn_kernels
from sage_icp_tpu_torch.ops.scan import trunc_div

MAX_ITERATIONS = 500
ESTIMATION_THRESHOLD = np.float32(1e-4)


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


def solve_increment(JTJ, JTr) -> torch.Tensor:
    """Solve (JTJ + 1e-8 I) x = -JTr by a 6x6 Cholesky unrolled over
    float32 scalars on the host. A non-finite solution becomes 0 (the
    loop then stops) and |x| is clamped to 10: a legitimate step is far
    smaller, and float32 se3_exp of a huge twist is not orthonormal.
    Returns x (6,) f32 on the host."""
    f32 = np.float32
    A = JTJ.detach().cpu().numpy().astype(f32) + f32(1e-8) * np.eye(6, dtype=f32)
    b = -JTr.detach().cpu().numpy().astype(f32)
    L = [[f32(0)] * 6 for _ in range(6)]
    with np.errstate(all="ignore"):
        for i in range(6):
            for j in range(i + 1):
                s = A[i, j] - sum((L[i][k] * L[j][k] for k in range(j)), f32(0))
                L[i][j] = np.sqrt(max(s, f32(1e-30))) if i == j else s / L[j][j]
        y = []
        for i in range(6):
            y.append((b[i] - sum((L[i][k] * y[k] for k in range(i)), f32(0))) / L[i][i])
        x = [f32(0)] * 6
        for i in reversed(range(6)):
            x[i] = (y[i] - sum((L[k][i] * x[k] for k in range(i + 1, 6)), f32(0))) / L[i][i]
        x = np.array(x, dtype=f32)
        if not np.all(np.isfinite(x)):
            x = np.zeros(6, dtype=f32)
        n = np.sqrt(np.sum(x * x, dtype=f32))
        if n > 10.0:
            x = x * (f32(10.0) / max(n, f32(1e-30)))
    return torch.from_numpy(x)


class IcpResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) on the frame's device
    iterations: int
    num_correspondences: int  # at the last iteration
    dropped_queries: torch.Tensor  # 0-dim int32: valid sources without a row seat


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


def register_frame(map_state: hm.MapState, frame, valid, initial_guess, voxel_size,
                   max_correspondence_distance, kernel, sem_th,
                   max_iterations: int = MAX_ITERATIONS, probe_depth: int = hm.DEFAULT_PROBE_DEPTH,
                   fast_params: dict | None = None, tables=None, mesh=None) -> IcpResult:
    """Frame-to-map ICP. frame (N, 4) sensor frame, valid (N,),
    initial_guess (4, 4). With fast_params (unique_voxel_rows /
    queries_per_voxel / overflow_rows) the frozen-rows engine runs: rows
    are built at an anchor pose, every iteration is one fused GN kernel
    call, and the rows are rebuilt at the current pose once the
    accumulated increment drifts 0.45 voxel. Without, each iteration runs
    the reference-shaped search.

    mesh (parallel.sharding.Mesh): the frozen rows are split across its
    ranks, each summing its share with the GN kernel (module docstring).
    The reference-shaped branch ignores it: every rank runs the whole
    search."""
    dev = frame.device
    eye = torch.eye(4, dtype=torch.float32)
    guess = initial_guess.detach().to("cpu", torch.float32)
    kernel = float(kernel)
    max_corr = float(max_correspondence_distance)

    if fast_params is None:
        source = geo.transform_points(guess.to(dev), frame)
        T_icp = eye
        it, ncorr = 0, 0
        last_norm = np.float32(np.inf)
        while it < max_iterations and last_norm >= ESTIMATION_THRESHOLD:
            tgt, accept = hm.get_correspondences(
                map_state, source, valid, voxel_size, max_corr, sem_th, probe_depth)
            JTJ, JTr = build_normal_equations(source, tgt, accept, kernel)
            x = solve_increment(JTJ, JTr)
            est = geo.se3_exp(x)
            source = geo.transform_points(est.to(dev), source)
            T_icp = est @ T_icp
            ncorr = int(accept.sum())
            last_norm = _norm(x).numpy()
            it += 1
        return IcpResult(pose=(T_icp @ guess).to(dev), iterations=it, num_correspondences=ncorr,
                         dropped_queries=torch.zeros((), dtype=torch.int32, device=dev))

    if tables is None:
        tables = cf.build_probe_tables(map_state, trunc_div(guess[:3, 3].to(dev), voxel_size), probe_depth)
    K = map_state.points_per_voxel
    offx, offy, offz = cf.lane_offsets(K, voxel_size, dev)
    scale = voxel_size / hm.QSCALE
    drift_lim = np.float32(0.45 * voxel_size)
    r2 = torch.sum(frame[:, :3] * frame[:, :3], dim=-1)
    r_scan = torch.sqrt(torch.max(torch.where(valid, r2, 0.0))).cpu()

    def setup_at(pose):
        return cf.corr_setup(map_state, tables, geo.transform_points(pose.to(dev), frame), valid,
                             voxel_size, probe_depth, **fast_params)

    def anchor_drift(T, anchor_pos):
        moved = T[:3, :3] @ anchor_pos + T[:3, 3] - anchor_pos
        cos_t = torch.clamp((torch.trace(T[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        return _norm(moved) + torch.arccos(cos_t) * r_scan

    def frozen_rows(setup):
        """This rank's rows [lo, hi) of the setup, as views (a plane's row
        stride 2M is a multiple of the GN kernel's load width, so a view
        keeps the plane base aligned), and their tile map."""
        R = setup.q0.shape[0]
        lo, hi = (0, R) if mesh is None else mesh.row_range(R)
        used = setup.grid_used[lo:hi].to(torch.int32)
        return dict(
            planes=[p[lo:hi] for p in (setup.cxp, setup.cyp, setup.czp, setup.clp)],
            q0=setup.q0.reshape(R, -1)[lo:hi].contiguous(),
            origin=setup.row_origin_abs[lo:hi].contiguous(),
            row_abs=(setup.row_rel + setup.center[None, :])[lo:hi].contiguous(),
            used=used,
            tile_map=nn_kernels.default_tile_map(used),
        )

    def gn_sums(T):
        sums = nn_kernels.fused_gn_iteration(
            *rows["planes"], offx, offy, offz,
            rows["q0"], rows["origin"], rows["row_abs"], rows["used"], T,
            sem_th, scale, voxel_size, max_corr, kernel, tile_map=rows["tile_map"],
        )
        if mesh is None:
            return sums.cpu()  # the iteration's one host sync
        parts = mesh.all_gather(sums[None]).cpu()  # (n, 18); the host sync
        total = parts[0]
        for part in parts[1:]:  # rank order, the same on every rank
            total = total + part
        return total

    anchor, T_icp = guess, eye
    setup = setup_at(anchor)
    rows = frozen_rows(setup)
    it, ncorr = 0, 0
    last_norm = np.float32(np.inf)
    drift = np.float32(0.0)
    while it < max_iterations and last_norm >= ESTIMATION_THRESHOLD:
        if drift >= drift_lim:
            anchor, T_icp = T_icp @ anchor, eye
            setup = setup_at(anchor)
            rows = frozen_rows(setup)
        JTJ, JTr, nc, _ = nn_kernels.assemble_normal_equations(gn_sums(T_icp))
        x = solve_increment(JTJ, JTr)
        T_icp = geo.se3_exp(x) @ T_icp
        ncorr = int(nc)
        last_norm = _norm(x).numpy()
        drift = anchor_drift(T_icp, anchor[:3, 3]).numpy()
        it += 1
    return IcpResult(pose=(T_icp @ anchor).to(dev), iterations=it, num_correspondences=ncorr,
                     dropped_queries=setup.n_dropped)
