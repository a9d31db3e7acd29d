"""The local map of the reference step: a fixed-capacity open-addressing
voxel table in device tensors, its insert with the retention policy, the
distance cull and the reference-shaped search.

    keys      int32 (C, 3)     voxel coordinate of each slot
    counts    int32 (C,)       live points in the slot's block (0 = free)
    points    int16 (C, 4, K)  planar quantized block [x | y | z | label]
    first_pts f32   (C, 3)     each block's first point, world frame

Points are int16 voxel-local offsets (full scale = one voxel). Slots are
found by triangular probing over probe_depth slots from a spatial hash; a
new voxel claims a slot in scatter-min rounds (the lowest row id wins).
Retention (VoxelBlock::AddPoint), replayed in scan order per voxel:
count < basic -> append; label 0 -> drop; basic class -> overwrite the
first stored label-0 point; critical class -> append while count < K,
else overwrite the first stored label-0 point. Updates are functional:
each returns new tensors. The optional dense voxel index of the program
changes no result and has no counterpart here."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .scan import INVALID_COORD, SORT_SENTINEL, trunc_div

EMPTY_KEY = -(1 << 20)
QSCALE = 32767.0
CLS_SHIFT = 12
LABEL_MASK = (1 << CLS_SHIFT) - 1
_U32 = 0xFFFFFFFF
_I32_MAX = 2**31 - 1
NEIGHBOR_OFFSETS = [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


class MapState(NamedTuple):
    keys: torch.Tensor
    counts: torch.Tensor
    points: torch.Tensor
    first_pts: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.counts.shape[0]

    @property
    def points_per_voxel(self) -> int:
        return self.points.shape[2]


class InsertStats(NamedTuple):
    unique_overflow: torch.Tensor
    claim_failures: torch.Tensor
    incoming_truncated: torch.Tensor


def create(capacity: int, points_per_voxel: int, device) -> MapState:
    return MapState(
        keys=torch.full((capacity, 3), EMPTY_KEY, dtype=torch.int32, device=device),
        counts=torch.zeros((capacity,), dtype=torch.int32, device=device),
        points=torch.zeros((capacity, 4, points_per_voxel), dtype=torch.int16, device=device),
        first_pts=torch.full((capacity, 3), INVALID_COORD, dtype=torch.float32, device=device),
    )


def neighbor_offsets(device) -> torch.Tensor:
    return torch.tensor(NEIGHBOR_OFFSETS, dtype=torch.int32, device=device)


def set_rows(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor, write: torch.Tensor) -> torch.Tensor:
    """dst with rows idx set to src where `write` holds; the other writes
    land in a spare row that is cut off."""
    n = dst.shape[0]
    out = torch.cat([dst, dst[:1]])
    out[torch.where(write, idx, n).long()] = src
    return out[:n]


def quantize_points(points: torch.Tensor, vkeys: torch.Tensor, voxel_size) -> torch.Tensor:
    local = points[..., :3] - vkeys.to(points.dtype) * voxel_size
    q = torch.clamp(torch.round(local * (QSCALE / voxel_size)), -QSCALE, QSCALE).to(torch.int16)
    return torch.cat([q, points[..., 3:4].to(torch.int16)], dim=-1)


def dequantize_blocks(stored: torch.Tensor, vkeys: torch.Tensor, voxel_size, dtype=torch.float32):
    """(..., 4, K) int16 planes -> (..., K, 4) world points."""
    xyz = stored[..., :3, :].to(dtype) * (voxel_size / QSCALE) + vkeys[..., :, None].to(dtype) * voxel_size
    lab = stored[..., 3:4, :].to(dtype)
    return torch.movedim(torch.cat([xyz, lab], dim=-2), -2, -1)


def probe_offset(d):
    return (d * (d + 1)) // 2


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash_keys(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    """x*73856093 ^ y*19349663 ^ z*83492791 in uint32, then Fibonacci
    mixing; (..., 3) int32 -> (..., ) int32 slot."""
    k = keys.to(torch.int64) & _U32
    h = _mul_u32(k[..., 0], 73856093) ^ _mul_u32(k[..., 1], 19349663) ^ _mul_u32(k[..., 2], 83492791)
    bits = int(capacity).bit_length() - 1
    return (_mul_u32(h, 2654435769) >> (32 - bits)).to(torch.int32)


def lookup(state: MapState, query_keys: torch.Tensor, probe_depth: int) -> torch.Tensor:
    """Slot of each voxel key (..., 3), or -1."""
    cap = state.capacity
    h = hash_keys(query_keys, cap)
    offs = probe_offset(torch.arange(probe_depth, dtype=torch.int32, device=h.device))
    slots = (h[..., None] + offs) & (cap - 1)
    match = torch.all(state.keys[slots.long()] == query_keys[..., None, :], dim=-1)
    first = torch.argmax(match.to(torch.int8), dim=-1, keepdim=True)
    return torch.where(match.any(dim=-1), torch.gather(slots, -1, first)[..., 0], -1)


def apply_policy(bx, by, bz, bl, counts, seglen, ix, iy, iz, ie, basic: int):
    """Round r applies incoming rank r of every row at once; rounds past
    every row's seglen would change nothing and are not run."""
    K = bx.shape[1]
    kidx = torch.arange(K, device=bx.device)[None, :]
    ox, oy, oz, ol = bx.clone(), by.clone(), bz.clone(), bl.clone()
    cnt = counts.clone()
    zero_live = (bl == 0) & (kidx < cnt[:, None])
    for r in range(min(ix.shape[1], int(seglen.max()))):
        act = r < seglen
        enc = ie[:, r].to(torch.int32)
        cls, lab = enc >> CLS_SHIFT, enc & LABEL_MASK
        has_zero = zero_live.any(dim=1)
        first_zero = torch.argmax(zero_live.to(torch.int32), dim=1)
        append_basic = cnt < basic
        do_append = act & (append_basic | (~append_basic & (cls == 2) & (cnt < K)))
        do_over = act & ~append_basic & (((cls == 1) | ((cls == 2) & (cnt >= K))) & has_zero)
        target = torch.where(do_append, cnt, first_zero)
        sel = (do_append | do_over)[:, None] & (kidx == target[:, None])
        ox = torch.where(sel, ix[:, r : r + 1], ox)
        oy = torch.where(sel, iy[:, r : r + 1], oy)
        oz = torch.where(sel, iz[:, r : r + 1], oz)
        ol = torch.where(sel, lab.to(torch.int16)[:, None], ol)
        zero_live = torch.where(sel, (lab == 0)[:, None], zero_live)
        cnt = cnt + do_append.to(torch.int32)
    return ox, oy, oz, ol, cnt


def insert(state: MapState, points, valid, voxel_size, basic_points: int, basic_label_mask: torch.Tensor,
           max_incoming_per_voxel: int, probe_depth: int, unique_voxel_capacity: int, slot_of=None):
    """Add (N, 4) world points (valid (N,)) under the retention policy.
    slot_of(keys) -> (found, slot) finds existing voxels (the frame's
    probe tables); without it the map is probed. Returns (map, stats)."""
    cap, kmax = state.capacity, state.points_per_voxel
    n, dev, U = points.shape[0], points.device, unique_voxel_capacity

    v = trunc_div(points[:, :3], voxel_size)
    vmin = torch.where(valid[:, None], v, 2**20).amin(dim=0)
    vo = torch.clamp(v - vmin, 0, 4095).to(torch.int64)
    key = torch.where(valid, (vo[:, 0] << 32) | (vo[:, 1] * 4096 + vo[:, 2]), SORT_SENTINEL)
    skey, order = torch.sort(key, stable=True)
    pts_sorted = points[order]
    vkeys = trunc_div(pts_sorted[:, :3], voxel_size)
    head = torch.ones_like(valid)
    head[1:] = skey[1:] != skey[:-1]
    val_sorted = skey != SORT_SENTINEL

    head_valid = head & val_sorted
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    u_rank = torch.cumsum(head_valid, 0, dtype=torch.int32) - 1
    head_pos = set_rows(torch.full((U,), n, dtype=torch.int32, device=dev), u_rank, pos, head_valid & (u_rank < U))
    hp_c = torch.clamp(head_pos, max=n - 1).long()
    ukeys = vkeys[hp_c]
    n_unique = head_valid.sum(dtype=torch.int32)
    u_live = torch.arange(U, device=dev) < torch.clamp(n_unique, max=U)
    seg_idx = torch.where(val_sorted & (u_rank < U), u_rank, U).long()
    seg_len = torch.zeros((U + 1,), dtype=torch.int32, device=dev)
    seg_len.index_add_(0, seg_idx, torch.ones_like(seg_idx, dtype=torch.int32))
    seg_len = seg_len[:U]

    if slot_of is None:
        slot_u = torch.where(u_live, lookup(state, ukeys, probe_depth), -1)
    else:
        found_u, slots_u = slot_of(ukeys)
        slot_u = torch.where(u_live & found_u, slots_u, -1)
    need_claim = u_live & (slot_u < 0)
    h = hash_keys(ukeys, cap)
    pre = u_live & (slot_u >= 0)
    taken = torch.cat([state.counts > 0, torch.zeros(1, dtype=torch.bool, device=dev)])
    taken.index_fill_(0, torch.where(pre, slot_u, cap).long(), True)
    uid = torch.arange(U, dtype=torch.int32, device=dev)
    claim = torch.empty((cap + 1,), dtype=torch.int32, device=dev)
    for d in range(probe_depth):
        unresolved = need_claim & (slot_u < 0)
        s = ((h + probe_offset(d)) & (cap - 1)).long()
        eligible = unresolved & ~taken[s]
        claim.fill_(_I32_MAX)
        claim.scatter_reduce_(0, torch.where(eligible, s, cap), uid, reduce="amin")
        won = eligible & (claim[s] == uid)
        slot_u = torch.where(won, s.to(torch.int32), slot_u)
        taken.index_fill_(0, torch.where(won, s, cap), True)
    newly = need_claim & (slot_u >= 0)
    has_slot = u_live & (slot_u >= 0)
    new_keys = set_rows(state.keys, slot_u, ukeys, newly)
    new_counts = set_rows(state.counts, slot_u, torch.zeros_like(slot_u), newly)
    stats = InsertStats(
        unique_overflow=torch.clamp(n_unique - U, min=0).to(torch.int32),
        claim_failures=(need_claim & (slot_u < 0)).sum(dtype=torch.int32),
        incoming_truncated=torch.where(u_live, torch.clamp(seg_len - max_incoming_per_voxel, min=0),
                                       0).sum(dtype=torch.int32),
    )

    num_labels = basic_label_mask.shape[0]
    Rmax = max_incoming_per_voxel
    slot_c = torch.where(has_slot, slot_u, 0).long()
    points2 = state.points.reshape(cap, 4 * kmax)
    compact = points2[slot_c].reshape(U, 4, kmax)
    lab_s = torch.clamp(pts_sorted[:, 3].to(torch.int32), 0, num_labels - 1)
    cls_s = torch.where(lab_s == 0, 0, torch.where(basic_label_mask[lab_s.long()], 1, 2))
    pq = quantize_points(pts_sorted, vkeys, voxel_size)
    enc = (lab_s | (cls_s << CLS_SHIFT)).to(torch.int16)
    win = (hp_c[:, None] + torch.arange(Rmax, device=dev)[None, :]) % n
    seglen = torch.where(has_slot, torch.clamp(seg_len, max=Rmax), 0)
    bx, by, bz, bl, cnt2 = apply_policy(compact[:, 0], compact[:, 1], compact[:, 2], compact[:, 3],
                                        new_counts[slot_c], seglen, pq[:, 0][win], pq[:, 1][win],
                                        pq[:, 2][win], enc[win], basic_points)
    # labels of lanes at or beyond a block's count are stored as -1
    kidx = torch.arange(kmax, device=dev)
    bl = torch.where(kidx[None, :] < cnt2[:, None], bl, -1).to(torch.int16)
    block = torch.stack([bx, by, bz, bl], dim=1)
    new_points = set_rows(points2, slot_u, block.reshape(U, 4 * kmax), has_slot).reshape(cap, 4, kmax)
    new_counts = set_rows(new_counts, slot_u, cnt2, has_slot)
    first_world = block[:, :3, 0].to(torch.float32) * (voxel_size / QSCALE) + ukeys.to(torch.float32) * voxel_size
    new_first = set_rows(state.first_pts, slot_u, first_world, has_slot)
    return MapState(new_keys, new_counts, new_points, new_first), stats


def remove_far(state: MapState, origin: torch.Tensor, max_distance) -> MapState:
    """Erase the blocks whose first point lies beyond max_distance."""
    d = state.first_pts - origin[None, :]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    kill = (state.counts > 0) & (d2 > max_distance * max_distance)
    return MapState(keys=torch.where(kill[:, None], EMPTY_KEY, state.keys),
                    counts=torch.where(kill, 0, state.counts), points=state.points,
                    first_pts=torch.where(kill[:, None], INVALID_COORD, state.first_pts))


def get_correspondences(state: MapState, query, valid, voxel_size, max_correspondence_distance, sem_th,
                        probe_depth: int):
    """Reference-shaped semantic NN over the 27 neighbouring voxels:
    arg-min of the sem_th-scaled squared distance (labels equal or either
    0), acceptance on the unweighted distance. (N, 4) -> (target, accept)."""
    kmax = state.points_per_voxel
    v = trunc_div(query[:, :3], voxel_size)
    nb = v[:, None, :] + neighbor_offsets(query.device)[None]
    slots = lookup(state, nb, probe_depth)
    found = slots >= 0
    safe = torch.where(found, slots, 0).long()
    cand = dequantize_blocks(state.points[safe], nb, voxel_size, query.dtype)
    cnt = state.counts[safe]
    kidx = torch.arange(kmax, device=query.device)
    cmask = found[..., None] & (kidx[None, None, :] < cnt[..., None])
    diff = cand[..., :3] - query[:, None, None, :3]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    ql = query[:, 3].to(torch.int32)[:, None, None]
    cl = cand[..., 3].to(torch.int32)
    d2w = torch.where((cl == ql) | (cl * ql == 0), d2 * sem_th, d2)
    d2w = torch.where(cmask, d2w, torch.finfo(d2.dtype).max)
    N = query.shape[0]
    best = torch.argmin(d2w.reshape(N, -1), dim=-1)
    rows = torch.arange(N, device=query.device)
    tgt = cand.reshape(N, -1, 4)[rows, best]
    d2_true = d2.reshape(N, -1)[rows, best]
    accept = valid & cmask.reshape(N, -1).any(dim=-1) & (torch.sqrt(d2_true) < max_correspondence_distance)
    return tgt, accept
