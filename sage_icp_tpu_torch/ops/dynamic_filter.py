"""Dynamic-vehicle filter: remove moving vehicles, keep parked ones.

The reference's PCL pipeline (cpp/sage_icp/core/Preprocessing.cpp:95-172)
on dense 0.5 m grids, as the JAX package computes it:

  * vehicle-class points cluster by 27-connectivity of their 0.5 m cells:
    24 rounds of 3x3x3 min-label diffusion over the dense grid;
  * each clustered point counts the landmark-class (parking/sidewalk
    44/48) points within 0.5 m, searched among the landmark points stored
    for the 27 neighbouring cells (32 per cell), by the radius_count
    kernel (ops/nn_kernels.py);
  * a cluster of at least 5 points is parked, and kept, iff its summed
    landmark count exceeds dy_th * its size; every other vehicle-class
    point is removed. Non-vehicle points pass through.

Vehicle/landmark labels only exist within label_max_range (preprocess
zeroes them beyond), so the grid has a static extent. Vehicle points
never clustered (beyond a capacity, or outside the grid's 16 m z span)
pass through and are counted in the overflow, as are clustered points
whose query slot in their cell row overflowed. Landmark cells beyond
_LMK_VOXEL_CAP are dropped, as in the JAX package, which counts them
nowhere; the port returns their number beside the overflow (the
pipeline keeps it out of StepAux, whose fields are JAX's).

The min-diffusion pools cell ids in float32, exact while the grid holds
fewer than 2^24 cells: label_max_range up to 179 m (every preset uses
50 m). A larger range is refused.

Every capacity and every decision here is the JAX module's, bit for bit:
keep mask and overflow agree with it.
"""

from __future__ import annotations

import functools
import math

import torch

from sage_icp_tpu_torch.ops import hashmap as hm
from sage_icp_tpu_torch.ops import nn_kernels
from sage_icp_tpu_torch.ops.scan import INVALID_COORD, label_in_set, trunc_div

CLUSTER_TOLERANCE = 0.5  # reference Preprocessing.cpp:133
MIN_CLUSTER_SIZE = 5  # reference Preprocessing.cpp:134
SEARCH_RADIUS = 0.5  # reference Preprocessing.cpp:148

# fixed capacities for the per-frame scratch structures
_LMK_VOXEL_CAP = 4096  # distinct 0.5 m cells holding landmark points
_LMK_PER_VOXEL = 32  # landmark points stored per cell
_CC_ITERS = 24  # min-diffusion rounds (cluster diameter bound, cells)
_VEH_PTS_CAP = 16384  # vehicle-class points per scan (within label range)
_VEH_ROW_CAP = 4096  # distinct 0.5 m cells holding vehicle points
_VEH_PER_ROW = 48  # vehicle query slots per cell row
_LMK_PTS_CAP = 49152  # landmark-class points per scan
_GRID_NZ = 32  # z cells: 16 m span around the sensor plane

_BIG = 2**30  # sort key of non-members; empty cell of the component grid
_SENT = 1.0e9  # coordinate of an invalid landmark lane: fails any radius test


@functools.lru_cache(maxsize=None)
def _grid_nx(label_max_range: float) -> int:
    """Cells per horizontal axis: labelled points lie within
    label_max_range of the sensor."""
    half = int(math.ceil((label_max_range + 2.0) / CLUSTER_TOLERANCE))
    return 2 * half


def _cell_lin(points, nx):
    """(N,) linearised 0.5 m grid cell per point + in-grid mask."""
    c = trunc_div(points[:, :3], CLUSTER_TOLERANCE)  # (N, 3)
    gx = c[:, 0] + nx // 2
    gy = c[:, 1] + nx // 2
    gz = c[:, 2] + _GRID_NZ // 2
    ok = (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < nx) & (gz >= 0) & (gz < _GRID_NZ)
    lin = (gx * nx + gy) * _GRID_NZ + gz
    return torch.where(ok, lin, 0), ok


def class_sort_keys(points, valid, config):
    """The keys of the filter's two class sorts, (N,) int32 each: a
    vehicle-class (landmark-class) point's grid cell, _BIG for every
    other point; and the (N,) vehicle-class mask."""
    nx = _grid_nx(float(config.label_max_range))
    labels = points[:, 3].to(torch.int32)
    lin, in_grid = _cell_lin(points, nx)
    is_vehicle = valid & label_in_set(labels, tuple(config.voxel_labels[config.dynamic_vehicle_voxid]))
    is_landmark = valid & label_in_set(labels, tuple(config.dynamic_remove_landmark))
    return (torch.where(is_vehicle & in_grid, lin, _BIG), torch.where(is_landmark & in_grid, lin, _BIG),
            is_vehicle)


def _sort_class(points, key, n_keep):
    """Stable sort the scan by `key` so that member points come first,
    grouped by grid cell; returns the leading min(N, n_keep) rows' (cell,
    xyz, original position, live mask, segment head)."""
    k_s, order = torch.sort(key, stable=True)
    k_s, order = k_s[:n_keep], order[:n_keep]
    xyz = points[order, :3]
    live = k_s != _BIG
    head = torch.ones_like(live)
    head[1:] = k_s[1:] != k_s[:-1]
    return k_s, xyz, order, live, head & live


def _scatter_set(size: int, fill, index, values):
    """(size,) filled with `fill`, values written at index; index == size
    is the sink of dropped writes (a spare slot, sliced off)."""
    out = torch.full((size + 1,), fill, dtype=values.dtype, device=values.device)
    out[index] = values
    return out[:size]


def _segment_len(size: int, index):
    """(size,) int32 count of each index < size; index == size is dropped."""
    out = torch.zeros((size + 1,), dtype=torch.int32, device=index.device)
    out.index_add_(0, index, torch.ones_like(index, dtype=torch.int32))
    return out[:size]


def _window(xyz, head_pos, width: int):
    """(rows, width, 3): row r holds the sorted rows (head_pos[r] + k) mod
    m, wrap-around included (the JAX module's rolls and row gather)."""
    m = xyz.shape[0]
    start = torch.clamp(head_pos, max=m - 1).long()
    idx = (start[:, None] + torch.arange(width, device=xyz.device)) % m
    return xyz[idx]


def filter_dynamic_vehicles(points, valid, config):
    """points (N, 4) cropped scan; valid (N,). Returns (points', valid',
    overflow, landmark_cells_dropped) with moving-vehicle points masked
    out, the pass-through overflow count and the number of distinct
    landmark cells beyond _LMK_VOXEL_CAP, whose points no radius count
    sees; both 0-dim int32."""
    dev = points.device
    n = points.shape[0]
    nx = _grid_nx(float(config.label_max_range))
    G = nx * nx * _GRID_NZ
    if G >= 2**24:
        raise ValueError(f"label_max_range {config.label_max_range} m: the filter's grid of {G} cells "
                         "exceeds the 2^24 its float32 min-diffusion holds exactly")
    veh_key, lmk_key, is_vehicle = class_sort_keys(points, valid, config)

    # ---- landmark storage: one stable sort -> (UL, K) rows of points ----
    UL, K = _LMK_VOXEL_CAP, _LMK_PER_VOXEL
    lk, lxyz, _, llive, l_head = _sort_class(points, lmk_key, _LMK_PTS_CAP)
    m = lk.shape[0]
    posm = torch.arange(m, dtype=torch.int32, device=dev)
    lu_rank = torch.cumsum(l_head, 0) - 1
    lmk_dropped = torch.clamp(l_head.sum(dtype=torch.int32) - UL, min=0)
    l_head_pos = _scatter_set(UL, m, torch.where(l_head & (lu_rank < UL), lu_rank, UL), posm)
    l_seg_len = _segment_len(UL, torch.where(llive & (lu_rank < UL), lu_rank, UL))
    kidx = torch.arange(K, device=dev)
    lane_valid = (l_head_pos < m)[:, None] & (kidx[None, :] < torch.clamp(l_seg_len, max=K)[:, None])
    lrows = torch.where(lane_valid[:, :, None], _window(lxyz, l_head_pos, K), _SENT)
    # +1 sentinel row for empty neighbour cells
    lplanes = torch.cat([lrows, torch.full((1, K, 3), _SENT, device=dev)])  # (UL+1, K, 3)
    # cell -> landmark row index (default UL = the sentinel row)
    l_cells = lk[torch.clamp(l_head_pos, max=m - 1).long()]
    grid_l = _scatter_set(G, UL, torch.where(l_head_pos < m, l_cells, G).long(),
                          torch.arange(UL, dtype=torch.int32, device=dev))

    # ---- vehicle side: one stable sort -> compacted, cell-grouped -------
    vk, vxyz, vpos, vlive, v_head = _sort_class(points, veh_key, _VEH_PTS_CAP)
    mv = vk.shape[0]
    posv = torch.arange(mv, device=dev)

    # ---- connected components on the dense occupancy grid ---------------
    # seed = own linear cell id; 27-connectivity min-diffusion as 3x3x3
    # min-pooling, i.e. max-pooling of the negated ids in float32 (exact:
    # ids < 2^24, and _BIG is a power of two); max_pool3d pads with -inf,
    # the identity of max, as the JAX reduce_window's init 2^30 is of min
    comp0 = torch.full((G + 1,), _BIG, dtype=torch.int32, device=dev)
    comp0.scatter_reduce_(0, torch.where(v_head, vk, G).long(), torch.where(v_head, vk, _BIG),
                          "amin", include_self=True)
    comp0 = comp0[:G]
    occ = (comp0 != _BIG).reshape(1, 1, nx, nx, _GRID_NZ)
    neg = -comp0.to(torch.float32).reshape(1, 1, nx, nx, _GRID_NZ)
    for _ in range(_CC_ITERS):
        pooled = torch.nn.functional.max_pool3d(neg, 3, stride=1, padding=1)
        neg = torch.where(occ, torch.maximum(neg, pooled), -float(_BIG))
    comp_flat = (-neg).to(torch.int32).reshape(G)

    # per-point cluster id + cluster sizes (ids are grid cells)
    pcomp = torch.where(vlive, comp_flat[torch.clamp(vk, max=G - 1).long()], G).long()
    sizes = torch.zeros((G + 1,), dtype=torch.int32, device=dev)
    sizes.index_add_(0, pcomp, torch.ones_like(pcomp, dtype=torch.int32))

    # ---- landmark neighbour count, deduplicated by query cell -----------
    VR, P = _VEH_ROW_CAP, _VEH_PER_ROW
    vu_rank = torch.cumsum(v_head, 0) - 1
    v_seg_start = torch.cummax(torch.where(v_head, posv, 0), 0).values
    v_rank = posv - v_seg_start
    vrow = torch.where(vlive & (vu_rank < VR), vu_rank, VR)
    vcol = torch.clamp(v_rank, max=P - 1)
    in_slot = vlive & (vrow < VR) & (v_rank < P)
    v_head_pos = _scatter_set(VR, mv, torch.where(v_head & (vu_rank < VR), vu_rank, VR),
                              posv.to(torch.int32))
    qrows = _window(vxyz, v_head_pos, P).reshape(VR, 3 * P)
    v_seg_len = _segment_len(VR, vrow)
    pidx = torch.arange(P, device=dev)
    row_live = v_head_pos < mv
    q_used = (row_live[:, None] & (pidx[None, :] < torch.clamp(v_seg_len, max=P)[:, None])).to(torch.int32)

    # 27 neighbour cells per query row -> landmark rows -> candidate planes
    row_cell = vk[torch.clamp(v_head_pos, max=mv - 1).long()]
    gz = row_cell % _GRID_NZ
    gy = (row_cell // _GRID_NZ) % nx
    gx = row_cell // (_GRID_NZ * nx)
    off = hm.neighbor_offsets(dev)  # (27, 3), the JAX package's order
    ngx = gx[:, None] + off[None, :, 0]
    ngy = gy[:, None] + off[None, :, 1]
    ngz = gz[:, None] + off[None, :, 2]
    nok = (
        (ngx >= 0) & (ngx < nx) & (ngy >= 0) & (ngy < nx)
        & (ngz >= 0) & (ngz < _GRID_NZ) & row_live[:, None]
    )
    nlin = torch.where(nok, (ngx * nx + ngy) * _GRID_NZ + ngz, 0)
    lrow_idx = torch.where(nok, grid_l[nlin.long()], UL)  # (VR, 27); UL = sentinel
    # (VR, 27, K, 3) -> three (VR, M) planes, lane = neighbour * K + k
    cx, cy, cz = lplanes[lrow_idx.long()].permute(3, 0, 1, 2).reshape(3, VR, 27 * K).contiguous()
    counts = nn_kernels.radius_count(
        cx, cy, cz, qrows.contiguous(), q_used, SEARCH_RADIUS * SEARCH_RADIUS)  # (VR, P) f32

    # per sorted vehicle point -> its slot's count; slot-overflow points
    # add 0 to the cluster total (counted below)
    flat = counts.reshape(-1)
    n_near = torch.where(in_slot, flat[torch.clamp(vrow * P + vcol, max=VR * P - 1)].to(torch.int32), 0)
    lmk_total = torch.zeros((G + 1,), dtype=torch.int32, device=dev)
    lmk_total.index_add_(0, pcomp, n_near)

    dy_th = torch.tensor(config.dynamic_vehicle_filter_th, dtype=torch.float32, device=dev)
    static_cluster = (sizes >= MIN_CLUSTER_SIZE) & (
        lmk_total.to(torch.float32) > dy_th * sizes.to(torch.float32))
    keep_sorted = vlive & static_cluster[torch.clamp(pcomp, max=G)]

    # ---- map the verdict back to the original scan order ----------------
    dest = torch.where(vlive, vpos, n)
    keep_full = _scatter_set(n, False, dest, keep_sorted)
    clustered = _scatter_set(n, False, dest, torch.ones_like(vlive))
    # pass-through: vehicle points never clustered (capacity or outside
    # the grid), counted so that capacity pressure is visible
    passthrough = is_vehicle & ~clustered
    new_valid = valid & (~is_vehicle | keep_full | passthrough)
    pts = torch.where(new_valid[:, None], points, INVALID_COORD)
    # overflow = never-clustered vehicle points plus clustered points whose
    # query slot overflowed P (their count was not added to the cluster)
    overflow = passthrough.sum(dtype=torch.int32) + (vlive & ~in_slot).sum(dtype=torch.int32)
    return pts, new_valid, overflow, lmk_dropped
