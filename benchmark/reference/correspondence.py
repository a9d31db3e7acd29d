"""Frozen correspondence rows of the reference step: the ICP sources
grouped by voxel into R rows of P query slots (plus overflow rows for
crowded voxels), each row's 27 neighbour blocks gathered once per anchor
pose into int16 candidate planes. Voxel keys are packed as 10-bit
offsets from a centre voxel; probe windows hold the packed keys of slots
i + probe_offset(d), d < probe_depth."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import voxel_map as vm
from .scan import trunc_div

PACK_BITS = 10
PACK_LIM = 255
_B = 1 << PACK_BITS
_NO_SEAT = 2**30


def fast_path_supported(voxel_size: float, local_map_range: float, max_range: float) -> bool:
    return (local_map_range + max_range) / voxel_size + 3.0 <= PACK_LIM


def pack_rel(rel: torch.Tensor) -> torch.Tensor:
    ok = torch.all(torch.abs(rel) <= PACK_LIM, dim=-1)
    code = (rel[..., 0] + 256) * (_B * _B) + (rel[..., 1] + 256) * _B + (rel[..., 2] + 256)
    return torch.where(ok, code, -1).to(torch.int32)


class ProbeTables(NamedTuple):
    window: torch.Tensor  # int32 (C, D)
    center: torch.Tensor  # int32 (3,)
    points2: torch.Tensor  # int16 (C, 4K)


def build_probe_tables(state: vm.MapState, center_voxel: torch.Tensor, probe_depth: int) -> ProbeTables:
    cap = state.capacity
    packed = pack_rel(state.keys - center_voxel[None, :])
    dev = packed.device
    offs = vm.probe_offset(torch.arange(probe_depth, device=dev))
    window = packed[(torch.arange(cap, device=dev)[:, None] + offs[None, :]) % cap]
    return ProbeTables(window, center_voxel, state.points.reshape(cap, 4 * state.points_per_voxel))


def probe(tables: ProbeTables, abs_keys: torch.Tensor, rel_codes: torch.Tensor):
    """(found, slot) of voxel keys: abs_keys hashed, rel_codes compared."""
    cap = tables.window.shape[0]
    h = vm.hash_keys(abs_keys, cap)
    match = (tables.window[h.long()] == rel_codes[..., None]) & (rel_codes[..., None] >= 0)
    d1 = torch.argmax(match.to(torch.int32), dim=-1)
    return match.any(dim=-1), ((h + vm.probe_offset(d1)) & (cap - 1)).to(torch.int32)


def slot_finder(tables: ProbeTables):
    """slot_of(keys) for voxel_map.insert: the frame's probe tables."""
    return lambda keys: probe(tables, keys, pack_rel(keys - tables.center[None, :]))


class Rows(NamedTuple):
    planes: tuple  # cx, cy, cz, cl: int16 (R, M), cl -1 = invalid lane
    q0: torch.Tensor  # f32 (R, P, 4) world xyz + label at the anchor
    used: torch.Tensor  # bool (R, P)
    row_abs: torch.Tensor  # int32 (R, 3)
    origin: torch.Tensor  # f32 (R, 3) row voxel origin, world
    n_dropped: torch.Tensor  # 0-dim int32: valid queries without a seat


def corr_setup(state: vm.MapState, tables: ProbeTables, query, valid, voxel_size, unique_voxel_rows: int,
               queries_per_voxel: int, overflow_rows: int) -> Rows:
    n, dev, K = query.shape[0], query.device, state.points_per_voxel
    Q, P, OV = unique_voxel_rows, queries_per_voxel, overflow_rows
    R = Q + OV
    center = tables.center
    rel = trunc_div(query[:, :3], voxel_size) - center[None, :]
    in_range = valid & torch.all(torch.abs(rel) <= PACK_LIM - 2, dim=-1)
    code = pack_rel(torch.clamp(rel, -PACK_LIM, PACK_LIM))
    sc, order = torch.sort(torch.where(in_range, code, _NO_SEAT), stable=True)
    q_s = query[order]
    val_s = sc != _NO_SEAT
    head = torch.ones_like(val_s)
    head[1:] = sc[1:] != sc[:-1]
    head = head & val_s
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    q_rank = pos - torch.cummax(torch.where(head, pos, 0), dim=0).values
    u_rank = torch.cumsum(head, 0, dtype=torch.int32) - 1
    is_ov = val_s & (q_rank >= P)
    ov_rank = torch.cumsum(is_ov, 0, dtype=torch.int32) - 1
    row = torch.where(val_s & ~is_ov & (u_rank < Q), u_rank, torch.where(is_ov & (ov_rank < OV), Q + ov_rank, R))

    rel_s = trunc_div(q_s[:, :3], voxel_size) - center[None, :]
    hp = vm.set_rows(torch.full((Q,), n, dtype=torch.int32, device=dev), u_rank, pos, head & (u_rank < Q))
    op = vm.set_rows(torch.full((OV,), n, dtype=torch.int32, device=dev), ov_rank, pos, is_ov & (ov_rank < OV))
    start = torch.cat([hp, op])
    row_live = start < n
    start_c = torch.clamp(start, max=n - 1).long()
    row_rel = torch.where(row_live[:, None], rel_s[start_c], 0)
    origin = (row_rel + center[None, :]).to(query.dtype) * voxel_size

    rec = torch.cat([q_s, torch.where(val_s, u_rank, -1).to(query.dtype)[:, None]], dim=1)
    p_iota = torch.arange(P, device=dev)
    g = rec[(start_c[:, None] + p_iota[None, :]) % n]  # (R, P, 5)
    row_uid = torch.arange(R, dtype=torch.int32, device=dev)[:, None]
    oob = torch.where(row_uid < Q, start[:, None] + p_iota[None, :] >= n,
                      (p_iota[None, :] > 0) | (start[:, None] >= n))
    used = torch.where(row_uid < Q, ~oob & (g[..., 4].to(torch.int32) == row_uid), ~oob & row_live[:, None])

    nb_rel = row_rel[:, None, :] + vm.neighbor_offsets(dev)[None]
    found, slot = probe(tables, nb_rel + center, torch.where(row_live[:, None], pack_rel(nb_rel), -1))
    raw = tables.points2[torch.where(found, slot, 0).reshape(-1).long()]
    M = 27 * K
    planes = raw.reshape(R, 27, 4, K).permute(2, 0, 1, 3).reshape(4, R, M)
    cm = found[..., None].expand(R, 27, K).reshape(R, M)
    n_dropped = valid.sum(dtype=torch.int32) - (val_s & (row < R)).sum(dtype=torch.int32)
    return Rows(planes=(planes[0], planes[1], planes[2], torch.where(cm, planes[3], -1).to(torch.int16)),
                q0=g[..., :4], used=used, row_abs=row_rel + center[None, :], origin=origin, n_dropped=n_dropped)


def lane_offsets(K: int, voxel_size, device):
    """Per-lane neighbour offsets in metres, three (1, 27K) planes."""
    offs = vm.neighbor_offsets(device).repeat_interleave(K, dim=0).to(torch.float32) * voxel_size
    return tuple(offs[:, a].reshape(1, -1).contiguous() for a in range(3))
