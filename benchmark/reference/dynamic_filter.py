"""The dynamic-vehicle filter of the reference step: remove moving
vehicles, keep parked ones (upstream Preprocessing.cpp:95-172 on dense
0.5 m grids).

  * vehicle-class points cluster by 27-connectivity of their 0.5 m
    cells: 24 rounds of 3x3x3 min-label diffusion over the dense grid;
  * each clustered point counts the landmark-class (44, 48) points within
    0.5 m among those stored for its 27 neighbouring cells (32 a cell);
  * a cluster of at least 5 points is parked, and kept, iff its summed
    landmark count exceeds dy_th times its size; every other
    vehicle-class point is removed.

Vehicle points never clustered (beyond a capacity, or outside the grid's
16 m z span) pass through and are counted in the overflow, as are
clustered points whose query slot in their cell row overflowed. Landmark
cells beyond the cap are dropped and counted apart."""

from __future__ import annotations

import math

import torch

from . import voxel_map as vm
from .scan import INVALID_COORD, const, label_in_set, trunc_div

CLUSTER_TOLERANCE = 0.5
MIN_CLUSTER_SIZE = 5
SEARCH_RADIUS = 0.5
_LMK_VOXEL_CAP = 4096
_LMK_PER_VOXEL = 32
_CC_ITERS = 24
_VEH_PTS_CAP = 16384
_VEH_ROW_CAP = 4096
_VEH_PER_ROW = 48
_LMK_PTS_CAP = 49152
_GRID_NZ = 32
_BIG = 2**30
_SENT = 1.0e9


def _grid_nx(label_max_range: float) -> int:
    return 2 * int(math.ceil((label_max_range + 2.0) / CLUSTER_TOLERANCE))


def _scatter_set(size: int, fill, index, values):
    out = torch.full((size + 1,), fill, dtype=values.dtype, device=values.device)
    out[index] = values
    return out[:size]


def _segment_len(size: int, index):
    out = torch.zeros((size + 1,), dtype=torch.int32, device=index.device)
    out.index_add_(0, index, torch.ones_like(index, dtype=torch.int32))
    return out[:size]


def _window(xyz, head_pos, width: int):
    m = xyz.shape[0]
    start = torch.clamp(head_pos, max=m - 1).long()
    return xyz[(start[:, None] + torch.arange(width, device=xyz.device)) % m]


def _sort_class(points, key, n_keep):
    k_s, order = torch.sort(key, stable=True)
    k_s, order = k_s[:n_keep], order[:n_keep]
    live = k_s != _BIG
    head = torch.ones_like(live)
    head[1:] = k_s[1:] != k_s[:-1]
    return k_s, points[order, :3], order, live, head & live


def radius_count(cx, cy, cz, queries, used, r2):
    """(R, P) count of a row's candidate lanes within the radius of each
    used query slot (d2 = (dx dx + dy dy) + dz dz <= r2); slots that no
    row uses count 0 and are not run."""
    P = int((used != 0).sum(dim=1).max())
    r2 = const(float(r2), torch.float32, cx.device)
    rows = torch.nonzero((used != 0).any(dim=1))[:, 0]
    cx, cy, cz, queries, live = cx[rows], cy[rows], cz[rows], queries[rows], used[rows]
    outs = []
    for p in range(P):
        dx = cx - queries[:, 3 * p : 3 * p + 1]
        dy = cy - queries[:, 3 * p + 1 : 3 * p + 2]
        dz = cz - queries[:, 3 * p + 2 : 3 * p + 3]
        cnt = ((dx * dx + dy * dy + dz * dz) <= r2).sum(dim=1, dtype=torch.int32).to(torch.float32)
        outs.append(cnt * live[:, p].to(torch.float32))
    out = torch.zeros(used.shape, dtype=torch.float32, device=used.device)
    if outs:
        out[rows, :P] = torch.stack(outs, dim=1)
    return out


def filter_dynamic_vehicles(points, valid, config: dict):
    """points (N, 4) cropped scan, valid (N,) -> (points', valid',
    overflow, landmark cells dropped), the last two 0-dim int32."""
    dev, n = points.device, points.shape[0]
    nx = _grid_nx(float(config["label_max_range"]))
    G = nx * nx * _GRID_NZ
    labels = points[:, 3].to(torch.int32)
    c = trunc_div(points[:, :3], CLUSTER_TOLERANCE)
    gx, gy, gz = c[:, 0] + nx // 2, c[:, 1] + nx // 2, c[:, 2] + _GRID_NZ // 2
    in_grid = (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < nx) & (gz >= 0) & (gz < _GRID_NZ)
    lin = torch.where(in_grid, (gx * nx + gy) * _GRID_NZ + gz, 0)
    vehicle_labels = tuple(config["voxel_labels"][config["dynamic_vehicle_voxid"]])
    is_vehicle = valid & label_in_set(labels, vehicle_labels)
    is_landmark = valid & label_in_set(labels, tuple(config["dynamic_remove_landmark"]))
    veh_key = torch.where(is_vehicle & in_grid, lin, _BIG)
    lmk_key = torch.where(is_landmark & in_grid, lin, _BIG)

    # landmark storage: (UL, K) rows of points, one per occupied cell
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
    lplanes = torch.cat([lrows, torch.full((1, K, 3), _SENT, device=dev)])
    l_cells = lk[torch.clamp(l_head_pos, max=m - 1).long()]
    grid_l = _scatter_set(G, UL, torch.where(l_head_pos < m, l_cells, G).long(),
                          torch.arange(UL, dtype=torch.int32, device=dev))

    # vehicle points: compacted and grouped by cell
    vk, vxyz, vpos, vlive, v_head = _sort_class(points, veh_key, _VEH_PTS_CAP)
    mv = vk.shape[0]
    posv = torch.arange(mv, device=dev)

    # 27-connected components: min-diffusion of cell ids (as max-pooling
    # of the negated ids in float32, exact below 2^24)
    comp0 = torch.full((G + 1,), _BIG, dtype=torch.int32, device=dev)
    comp0.scatter_reduce_(0, torch.where(v_head, vk, G).long(), torch.where(v_head, vk, _BIG), "amin",
                          include_self=True)
    grid = comp0[:G].reshape(1, 1, nx, nx, _GRID_NZ)
    occ = grid != _BIG
    neg = -grid.to(torch.float32)
    for _ in range(_CC_ITERS):
        neg = torch.where(occ, torch.maximum(neg, torch.nn.functional.max_pool3d(neg, 3, stride=1, padding=1)),
                          -float(_BIG))
    comp_flat = (-neg).to(torch.int32).reshape(-1)
    pcomp = torch.where(vlive, comp_flat[torch.clamp(vk, max=G - 1).long()], G).long()
    sizes = torch.zeros((G + 1,), dtype=torch.int32, device=dev)
    sizes.index_add_(0, pcomp, torch.ones_like(pcomp, dtype=torch.int32))

    # landmark neighbour counts, one query row per vehicle cell
    VR, P = _VEH_ROW_CAP, _VEH_PER_ROW
    vu_rank = torch.cumsum(v_head, 0) - 1
    v_rank = posv - torch.cummax(torch.where(v_head, posv, 0), 0).values
    vrow = torch.where(vlive & (vu_rank < VR), vu_rank, VR)
    vcol = torch.clamp(v_rank, max=P - 1)
    in_slot = vlive & (vrow < VR) & (v_rank < P)
    v_head_pos = _scatter_set(VR, mv, torch.where(v_head & (vu_rank < VR), vu_rank, VR), posv.to(torch.int32))
    v_seg_len = _segment_len(VR, vrow)
    qrows = _window(vxyz, v_head_pos, P).reshape(VR, 3 * P)
    pidx = torch.arange(P, device=dev)
    row_live = v_head_pos < mv
    q_used = (row_live[:, None] & (pidx[None, :] < torch.clamp(v_seg_len, max=P)[:, None])).to(torch.int32)
    row_cell = vk[torch.clamp(v_head_pos, max=mv - 1).long()]
    rgz, rgy, rgx = row_cell % _GRID_NZ, (row_cell // _GRID_NZ) % nx, row_cell // (_GRID_NZ * nx)
    off = vm.neighbor_offsets(dev)
    ngx, ngy, ngz = rgx[:, None] + off[None, :, 0], rgy[:, None] + off[None, :, 1], rgz[:, None] + off[None, :, 2]
    nok = (ngx >= 0) & (ngx < nx) & (ngy >= 0) & (ngy < nx) & (ngz >= 0) & (ngz < _GRID_NZ) & row_live[:, None]
    nlin = torch.where(nok, (ngx * nx + ngy) * _GRID_NZ + ngz, 0)
    lrow_idx = torch.where(nok, grid_l[nlin.long()], UL)
    cx, cy, cz = lplanes[lrow_idx.long()].permute(3, 0, 1, 2).reshape(3, VR, 27 * K).contiguous()
    counts = radius_count(cx, cy, cz, qrows.contiguous(), q_used, SEARCH_RADIUS * SEARCH_RADIUS)

    n_near = torch.where(in_slot, counts.reshape(-1)[torch.clamp(vrow * P + vcol, max=VR * P - 1)].to(torch.int32), 0)
    lmk_total = torch.zeros((G + 1,), dtype=torch.int32, device=dev)
    lmk_total.index_add_(0, pcomp, n_near)
    dy_th = const(config["dynamic_vehicle_filter_th"], torch.float32, dev)
    static_cluster = (sizes >= MIN_CLUSTER_SIZE) & (lmk_total.to(torch.float32) > dy_th * sizes.to(torch.float32))
    keep_sorted = vlive & static_cluster[torch.clamp(pcomp, max=G)]

    dest = torch.where(vlive, vpos, n)
    keep_full = _scatter_set(n, False, dest, keep_sorted)
    clustered = _scatter_set(n, False, dest, torch.ones_like(vlive))
    passthrough = is_vehicle & ~clustered
    new_valid = valid & (~is_vehicle | keep_full | passthrough)
    overflow = passthrough.sum(dtype=torch.int32) + (vlive & ~in_slot).sum(dtype=torch.int32)
    return torch.where(new_valid[:, None], points, INVALID_COORD), new_valid, overflow, lmk_dropped
