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
  * The planes' probe and gather (candidate_planes) are one launch of
    csrc/corr_planes.cu on the card, and plain PyTorch on the CPU
    (candidate_planes_plain).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sage_icp_tpu_torch.ops import cuda_lib, nn_kernels
from sage_icp_tpu_torch.ops import hashmap as hm
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


_CP_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4


def plane_store_bytes(K: int) -> int:
    """The kernel's store width: the widest of 16, 8, 4 and 2 bytes that
    divides a neighbour's 2K-byte segment."""
    return next(w for w in (16, 8, 4, 2) if (2 * K) % w == 0)


def candidate_planes(tables: ProbeTables, row_rel, row_live, K: int, probe_depth: int, grid_hits=None,
                     found_pairs=None):
    """The rows' candidate planes (cx, cy, cz, cl), each (R', 27K) int16:
    lanes [nK, nK + K) of a row hold the block of its neighbour n (row_rel
    (R', 3) int32 + NEIGHBOR_OFFSETS[n]), slot 0's where the neighbour is
    not found, and cl -1 there. A dead row (row_live (R',) bool false) or
    an out-of-range neighbour finds nothing. The neighbours' slots come
    from the probe tables, or from grid_hits ((found, slot), each (R', 27),
    found false in dead rows: the dense index). found_pairs (a 0-dim int32
    tensor): the found (row, neighbour) pairs are added to it. On a CUDA
    tensor one launch of csrc/corr_planes.cu, the planes the rows of one
    (4, R', 27K) tensor; on the CPU candidate_planes_plain."""
    if cuda_lib.on_cpu(row_rel):
        return candidate_planes_plain(tables, row_rel, row_live, K, probe_depth, grid_hits, found_pairs)
    Rl = row_rel.shape[0]
    cap = tables.window.shape[0]
    dev = row_rel.device
    cuda_lib.check_cuda("row_rel", row_rel, torch.int32, (Rl, 3))
    cuda_lib.check_cuda("row_live", row_live, torch.bool, (Rl,))
    cuda_lib.check_cuda("center", tables.center, torch.int32, (3,))
    cuda_lib.check_cuda("window", tables.window, torch.int32, (cap, probe_depth))
    cuda_lib.check_cuda("points2", tables.points2, torch.int16, (cap, 4 * K))
    if cap & (cap - 1):
        raise ValueError(f"candidate_planes: the map's capacity {cap} is not a power of two")
    width = plane_store_bytes(K)
    if tables.points2.data_ptr() % width:
        raise ValueError(f"points2: the kernel copies {2 * K}-byte segments {width} B at a time; the base address "
                         f"must be {width}-byte aligned")
    found, slot = (None, None) if grid_hits is None else grid_hits
    if grid_hits is not None:
        cuda_lib.check_cuda("grid found", found, torch.bool, (Rl, 27))
        cuda_lib.check_cuda("grid slot", slot, torch.int32, (Rl, 27))
    if found_pairs is not None:
        cuda_lib.check_cuda("found_pairs", found_pairs, torch.int32, ())
    planes = torch.empty((4, Rl, 27 * K), dtype=torch.int16, device=dev)
    fn = cuda_lib.function("corr_planes.cu", "sage_corr_planes", _CP_ARGTYPES)
    p = cuda_lib.ptr
    opt = lambda t: None if t is None else p(t)
    cuda_lib.call("corr_planes", fn, dev, p(row_rel), p(row_live), p(tables.center), p(tables.window),
                  p(tables.points2), opt(found), opt(slot), Rl, cap.bit_length() - 1, probe_depth, K, width,
                  p(planes), opt(found_pairs))
    return tuple(planes)


def candidate_planes_plain(tables: ProbeTables, row_rel, row_live, K: int, probe_depth: int, grid_hits=None,
                           found_pairs=None):
    """candidate_planes by the probe, one row gather of the blocks, a
    permute into planes and the label plane masked."""
    Rl = row_rel.shape[0]
    if grid_hits is None:
        nb_rel = row_rel[:, None, :] + hm.neighbor_offsets(row_rel.device)[None]  # (R', 27, 3)
        nb_code = torch.where(row_live[:, None], pack_rel(nb_rel), -1)
        found, slot = probe(tables, nb_rel + tables.center, nb_code, probe_depth)
    else:
        found, slot = grid_hits
    if found_pairs is not None:
        found_pairs.add_(found.sum(dtype=torch.int32))
    raw = tables.points2[torch.where(found, slot, 0).reshape(-1).long()]  # (R'*27, 4K)
    M = 27 * K
    planes = raw.reshape(Rl, 27, 4, K).permute(2, 0, 1, 3).reshape(4, Rl, M)
    cm = found[..., None].expand(Rl, 27, K).reshape(Rl, M)
    return planes[0], planes[1], planes[2], torch.where(cm, planes[3], -1).to(torch.int16)


class CorrSetup(NamedTuple):
    """Queries grouped into voxel rows with their 27-neighbourhood
    candidates gathered once per anchor pose. A query that drifts during
    the solve keeps matching against its setup row's neighbourhood while
    it stays within one voxel of it. The planes, q0, grid_used and
    row_origin_abs hold R' rows: all R, or one rank's share (corr_setup's
    `rows`)."""

    cxp: torch.Tensor  # int16 (R', M) candidate x, own-voxel-local quantized
    cyp: torch.Tensor
    czp: torch.Tensor
    clp: torch.Tensor  # int16 (R', M) candidate labels; -1 = invalid lane
    q0: torch.Tensor  # f32 (R', P, 4) query world xyz + label at setup
    grid_used: torch.Tensor  # bool (R', P)
    row_rel: torch.Tensor  # int32 (R, 3) row voxel relative to center, every row
    row_origin_abs: torch.Tensor  # f32 (R', 3) row voxel origin, world
    center: torch.Tensor  # int32 (3,)
    order: torch.Tensor  # (N,) sort permutation
    row: torch.Tensor  # (N,) sorted query -> row (R = no seat)
    col: torch.Tensor  # (N,) sorted query -> slot
    n_dropped: torch.Tensor  # 0-dim int32: valid queries with no seat


def corr_setup(state: hm.MapState, tables: ProbeTables, query, valid, voxel_size, probe_depth: int,
               unique_voxel_rows: int = 4096, queries_per_voxel: int = 8,
               overflow_rows: int = 1024, rows: tuple[int, int] | None = None,
               found_pairs: torch.Tensor | None = None) -> CorrSetup:
    """Group (N, 4) world-frame queries by voxel and gather their
    candidate planes (candidate_planes). The neighbours' slots come from
    the map's dense index when it has one, else from the probe tables; the
    planes come from tables.points2 either way. Never synchronises the
    host. found_pairs (a 0-dim int32 tensor): the rows' found (row,
    neighbour) pairs are added to it.

    rows (lo, hi): one rank's share of the R rows (parallel/sharding.py).
    The query sort, the seats (order, row, col, n_dropped) and row_rel
    stay whole, so every rank numbers rows and queries alike; the planes,
    q0, grid_used and row_origin_abs are rows [lo, hi) only, equal to
    those rows of the whole setup."""
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
    row_live_all = start < n
    row_rel = torch.where(row_live_all[:, None], rel_s[torch.clamp(start, max=n - 1).long()], 0)

    # the rows [lo, hi) from here on
    lo, hi = (0, R) if rows is None else rows
    start, row_live, rel_l = start[lo:hi], row_live_all[lo:hi], row_rel[lo:hi]
    start_c = torch.clamp(start, max=n - 1).long()
    row_origin_abs = (rel_l + center[None, :]).to(query.dtype) * voxel_size

    rec = torch.cat([q_s, torch.where(val_s, u_rank, -1).to(query.dtype)[:, None]], dim=1)
    p_iota = torch.arange(P, device=dev)
    g = rec[(start_c[:, None] + p_iota[None, :]) % n]  # (R', P, 5), wraps like a roll
    row_uid = torch.arange(lo, hi, dtype=torch.int32, device=dev)[:, None]
    oob = torch.where(
        row_uid < Q,
        start[:, None] + p_iota[None, :] >= n,
        (p_iota[None, :] > 0) | (start[:, None] >= n),  # overflow rows: slot 0 only
    )
    grid_used = torch.where(
        row_uid < Q,
        ~oob & (g[..., 4].to(torch.int32) == row_uid),
        ~oob & row_live[:, None],
    )

    grid_hits = None
    if state.grid is not None:
        # the dense index: one 8-byte row per neighbour in place of a
        # probe_depth-deep window row
        found, slot = hm.grid_probe(state, rel_l[:, None, :] + hm.neighbor_offsets(dev)[None] + center)
        grid_hits = (found & row_live[:, None], slot)
    cxp, cyp, czp, clp = candidate_planes(tables, rel_l, row_live, K, probe_depth, grid_hits, found_pairs)
    n_dropped = valid.sum(dtype=torch.int32) - (val_s & (row < R)).sum(dtype=torch.int32)
    return CorrSetup(
        cxp=cxp, cyp=cyp, czp=czp, clp=clp,
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
