"""Frozen-row semantic correspondence search and packed-window probing:
the same semantics as hashmap.get_correspondences / lookup, restructured
as in the JAX reference package.

  * Probe windows: ProbeTables.window[i] holds the packed keys of slots
    i + probe_offset(d), d < D, so one probe is one row gather and one
    integer compare per slot.
  * Voxel keys pack into one int32 as 10-bit offsets from a frame centre
    voxel.
  * Queries are sorted and grouped by voxel into R rows of P slots (plus
    overflow rows for crowded voxels); each row gathers its 27 neighbour
    blocks once into int16 candidate planes (corr_setup). A GN iteration
    then only re-applies the pose increment to the queries and runs the
    selection kernel over the frozen rows (nn_kernels).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sage_icp_tpu_torch.ops import hashmap as hm
from sage_icp_tpu_torch.ops import nn_kernels
from sage_icp_tpu_torch.ops.scan import trunc_div

PACK_BITS = 10  # 10-bit per-axis offsets: rel coords must fit +-255
PACK_LIM = 255
_B = 1 << PACK_BITS
_NO_SEAT = 2**30  # sort code of a query with no row


def fast_path_supported(voxel_size: float, local_map_range: float, max_range: float) -> bool:
    """Packed 10-bit offsets cover (map extent + scan extent) voxels."""
    return (local_map_range + max_range) / voxel_size + 3.0 <= PACK_LIM


def pack_rel(rel: torch.Tensor) -> torch.Tensor:
    """(…, 3) int32 relative voxel coords -> one non-negative int32 code;
    out-of-range coords give -1 (matches nothing)."""
    ok = torch.all(torch.abs(rel) <= PACK_LIM, dim=-1)
    code = (rel[..., 0] + 256) * (_B * _B) + (rel[..., 1] + 256) * _B + (rel[..., 2] + 256)
    return torch.where(ok, code, -1).to(torch.int32)


class ProbeTables(NamedTuple):
    window: torch.Tensor  # int32 (C, D) packed keys of slots i + probe_offset(d)
    center: torch.Tensor  # int32 (3,) packing centre voxel
    points2: torch.Tensor  # int16 (C, 4K) planar block view of the map


def build_probe_tables(state: hm.MapState, center_voxel: torch.Tensor, probe_depth: int) -> ProbeTables:
    cap = state.capacity
    packed = pack_rel(state.keys - center_voxel[None, :])
    dev = packed.device
    offs = hm.probe_offset(torch.arange(probe_depth, device=dev))
    window = packed[(torch.arange(cap, device=dev)[:, None] + offs[None, :]) % cap]
    return ProbeTables(window=window, center=center_voxel,
                       points2=state.points.reshape(cap, 4 * state.points_per_voxel))


def probe(tables: ProbeTables, abs_keys: torch.Tensor, rel_codes: torch.Tensor, probe_depth: int):
    """Slots of voxel keys: abs_keys (…, 3) for hashing, rel_codes (…,)
    packed for comparison. Returns (found bool, slot int32)."""
    cap = tables.window.shape[0]
    h = hm.hash_keys(abs_keys, cap)
    win = tables.window[h.long()]  # (…, D)
    match = (win == rel_codes[..., None]) & (rel_codes[..., None] >= 0)
    d1 = torch.argmax(match.to(torch.int32), dim=-1)
    slot = ((h + hm.probe_offset(d1)) & (cap - 1)).to(torch.int32)
    return match.any(dim=-1), slot


class CorrSetup(NamedTuple):
    """Queries grouped into voxel rows with their 27-neighbourhood
    candidates gathered once per anchor pose. A query that drifts during
    the solve keeps matching against its setup row's neighbourhood while
    it stays within one voxel of it."""

    cxp: torch.Tensor  # int16 (R, M) candidate x, own-voxel-local quantized
    cyp: torch.Tensor
    czp: torch.Tensor
    clp: torch.Tensor  # int16 (R, M) candidate labels; -1 = invalid lane
    q0: torch.Tensor  # f32 (R, P, 4) query world xyz + label at setup
    grid_used: torch.Tensor  # bool (R, P)
    row_rel: torch.Tensor  # int32 (R, 3) row voxel relative to center
    row_origin_abs: torch.Tensor  # f32 (R, 3) row voxel origin, world
    center: torch.Tensor  # int32 (3,)
    order: torch.Tensor  # (N,) sort permutation
    row: torch.Tensor  # (N,) sorted query -> row (R = no seat)
    col: torch.Tensor  # (N,) sorted query -> slot
    n_dropped: torch.Tensor  # 0-dim int32: valid queries with no seat


def corr_setup(state: hm.MapState, tables: ProbeTables, query, valid, voxel_size, probe_depth: int,
               unique_voxel_rows: int = 4096, queries_per_voxel: int = 8,
               overflow_rows: int = 1024) -> CorrSetup:
    """Group (N, 4) world-frame queries by voxel and gather their
    candidate planes. The neighbours' slots come from the map's dense
    index when it has one, else from the probe tables; the planes come
    from tables.points2 either way. Never synchronises the host."""
    n = query.shape[0]
    dev = query.device
    K = state.points_per_voxel
    Q, P, OV = unique_voxel_rows, queries_per_voxel, overflow_rows
    R = Q + OV
    center = tables.center

    rel = trunc_div(query[:, :3], voxel_size) - center[None, :]
    in_range = valid & torch.all(torch.abs(rel) <= PACK_LIM - 2, dim=-1)
    code = pack_rel(torch.clamp(rel, -PACK_LIM, PACK_LIM))
    sortcode = torch.where(in_range, code, _NO_SEAT)
    sc, order = torch.sort(sortcode, stable=True)
    q_s = query[order]
    val_s = sc != _NO_SEAT
    head = torch.ones_like(val_s)
    head[1:] = sc[1:] != sc[:-1]
    head = head & val_s
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    seg_start = torch.cummax(torch.where(head, pos, 0), dim=0).values
    q_rank = pos - seg_start
    u_rank = torch.cumsum(head, 0, dtype=torch.int32) - 1

    is_ov = val_s & (q_rank >= P)
    ov_rank = torch.cumsum(is_ov, 0, dtype=torch.int32) - 1
    row = torch.where(
        val_s & ~is_ov & (u_rank < Q), u_rank,
        torch.where(is_ov & (ov_rank < OV), Q + ov_rank, R),
    )
    col = torch.where(is_ov, 0, torch.clamp(q_rank, max=P - 1))

    # row r's queries sit at sorted positions start[r] + p
    rel_s = trunc_div(q_s[:, :3], voxel_size) - center[None, :]
    hp = hm.set_rows(torch.full((Q,), n, dtype=torch.int32, device=dev), u_rank, pos, head & (u_rank < Q))
    op = hm.set_rows(torch.full((OV,), n, dtype=torch.int32, device=dev), ov_rank, pos, is_ov & (ov_rank < OV))
    start = torch.cat([hp, op])
    row_live = start < n
    start_c = torch.clamp(start, max=n - 1).long()
    row_rel = torch.where(row_live[:, None], rel_s[start_c], 0)
    row_origin_abs = (row_rel + center[None, :]).to(query.dtype) * voxel_size

    rec = torch.cat([q_s, torch.where(val_s, u_rank, -1).to(query.dtype)[:, None]], dim=1)
    p_iota = torch.arange(P, device=dev)
    g = rec[(start_c[:, None] + p_iota[None, :]) % n]  # (R, P, 5), wraps like a roll
    oob = torch.cat([
        hp[:, None] + p_iota[None, :] >= n,
        (p_iota[None, :] > 0) | (op[:, None] >= n),  # overflow rows: slot 0 only
    ])
    row_uid = torch.arange(R, dtype=torch.int32, device=dev)[:, None]
    grid_used = torch.where(
        row_uid < Q,
        ~oob & (g[..., 4].to(torch.int32) == row_uid),
        ~oob & row_live[:, None],
    )

    nb_rel = row_rel[:, None, :] + hm.neighbor_offsets(dev)[None]  # (R, 27, 3)
    if state.grid is not None:
        # the dense index: one 8-byte row per neighbour in place of a
        # probe_depth-deep window row
        found, slot = hm.grid_probe(state, nb_rel + center)
        found = found & row_live[:, None]
    else:
        nb_code = torch.where(row_live[:, None], pack_rel(nb_rel), -1)
        found, slot = probe(tables, nb_rel + center, nb_code, probe_depth)

    raw = tables.points2[torch.where(found, slot, 0).reshape(-1).long()]  # (R*27, 4K)
    M = 27 * K
    planes = raw.reshape(R, 27, 4, K).permute(2, 0, 1, 3).reshape(4, R, M)
    cm = found[..., None].expand(R, 27, K).reshape(R, M)
    n_dropped = valid.sum(dtype=torch.int32) - (val_s & (row < R)).sum(dtype=torch.int32)
    return CorrSetup(
        cxp=planes[0], cyp=planes[1], czp=planes[2],
        clp=torch.where(cm, planes[3], -1).to(torch.int16),
        q0=g[..., :4], grid_used=grid_used, row_rel=row_rel, row_origin_abs=row_origin_abs,
        center=center, order=order, row=row, col=col, n_dropped=n_dropped,
    )


def lane_offsets(K: int, voxel_size, device=None):
    """(1, 27K) f32 per-lane neighbour offsets in metres, x/y/z planes."""
    offs = hm.neighbor_offsets(device).repeat_interleave(K, dim=0).to(torch.float32) * voxel_size
    return tuple(offs[:, a].reshape(1, -1).contiguous() for a in range(3))


def corr_apply(setup: CorrSetup, T, voxel_size, max_correspondence_distance, sem_th):
    """One semantic NN pass on the frozen rows under the pose increment T
    (identity on a first pass: then this is the reference search).
    Returns (src_world (R, P, 4), tgt_world (R, P, 4), accept (R, P))."""
    R, P, _ = setup.q0.shape
    K = setup.cxp.shape[1] // 27
    xyz0 = setup.q0[..., :3]
    q_w = xyz0 @ T[:3, :3].T + T[:3, 3]
    lab = setup.q0[..., 3]
    moved = torch.any(
        torch.abs(trunc_div(q_w, voxel_size) - setup.center - setup.row_rel[:, None, :]) > 1, dim=-1
    )
    used = setup.grid_used & ~moved
    origin = setup.row_origin_abs
    q_loc = q_w - origin[:, None, :]
    q4 = torch.cat([q_loc, lab[..., None]], dim=-1).reshape(R, 4 * P).contiguous()
    offx, offy, offz = lane_offsets(K, voxel_size, q4.device)
    tx, ty, tz, tl, d2t = nn_kernels.fused_semantic_nn(
        setup.cxp, setup.cyp, setup.czp, setup.clp, offx, offy, offz, q4, sem_th, voxel_size / hm.QSCALE,
    )
    tgt = torch.stack([tx + origin[:, 0:1], ty + origin[:, 1:2], tz + origin[:, 2:3], tl], dim=-1)
    # an invalid winner carries BIG_D2 and fails the gate
    accept = used & (torch.sqrt(d2t) < max_correspondence_distance)
    return torch.cat([q_w, lab[..., None]], dim=-1), tgt, accept


def get_correspondences_fast(state, tables, query, valid, voxel_size, max_correspondence_distance,
                             sem_th, probe_depth: int, unique_voxel_rows: int = 4096,
                             queries_per_voxel: int = 8, overflow_rows: int = 1024):
    """Single-pass search, a drop-in for hashmap.get_correspondences:
    (N, 4) queries -> (target (N, 4), accept (N,))."""
    n = query.shape[0]
    setup = corr_setup(state, tables, query, valid, voxel_size, probe_depth,
                       unique_voxel_rows, queries_per_voxel, overflow_rows)
    eye = torch.eye(4, dtype=query.dtype, device=query.device)
    _, tgt_grid, accept_grid = corr_apply(setup, eye, voxel_size, max_correspondence_distance, sem_th)
    R = setup.grid_used.shape[0]
    seated = setup.row < R
    row_c = torch.where(seated, setup.row, 0).long()
    col = setup.col.long()
    tgt_sorted = tgt_grid[row_c, col]
    acc_sorted = seated & accept_grid[row_c, col]
    inv_order = torch.empty_like(setup.order)
    inv_order[setup.order] = torch.arange(n, device=query.device)
    return tgt_sorted[inv_order], acc_sorted[inv_order]
