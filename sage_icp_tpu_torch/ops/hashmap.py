"""Semantic voxel-hash local map: a fixed-capacity open-addressing table
held in device tensors, the same layout and semantics as the JAX
reference package's map (and, through it, the reference's
tsl::robin_map<Voxel, VoxelBlock>).

    keys:      int32 (C, 3)     voxel coordinate of each slot
    counts:    int32 (C,)       live points in the slot's block (0 = free)
    points:    int16 (C, 4, K)  PLANAR quantized block [x | y | z | label]
    first_pts: f32   (C, 3)     each block's first point, world frame
    grid:      int32 (2^22, 2)  optional dense index [slot | hi-check]

Points are stored as int16 voxel-local offsets (full scale = one voxel).
Collisions use triangular probing over probe_depth slots; a new voxel
claims a slot in scatter-min rounds (lowest row id wins a race). Every
drop is counted in InsertStats.

The dense index (dense_grid): a torus of 256 x 256 x 64 voxel cells,
each holding the slot of the live voxel in it and a checksum of the
coordinate bits above the torus period. One 8-byte row gather finds a
voxel's slot instead of a probe_depth-deep window. It is alias-free while
the culled map spans fewer cells than the period (the pipeline's
init_state refuses configurations that could exceed it); insert and
remove_far keep it in step with the table.

Retention policy (VoxelBlock::AddPoint), applied in scan order per voxel
by ops.policy_kernel.apply_policy:
  count < basic -> append; label 0 -> drop; basic class -> overwrite the
  first stored label-0 point; critical class -> append while count < K,
  else overwrite the first stored label-0 point.

Updates are functional by default, like the reference: insert and
remove_far return new tensors and leave the input state untouched. The
one large copy per frame is the (C, 4, K) block buffer (42 MB at the city
preset, tens of microseconds on the card); with the dense index, the 32
MiB grid is copied once by insert and once by remove_far. With
in_place=True they update a donated map (`create`'s layout, or
`with_spare`'s copy: every tensor the first rows of a buffer with one
spare row, where dropped writes land) in place and copy nothing, the
counterpart of the JAX step's donated state; every read of the old map
comes before the first write.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sage_icp_tpu_torch.ops import policy_kernel
from sage_icp_tpu_torch.ops.constants import device_constant
from sage_icp_tpu_torch.ops.scan import INVALID_COORD, SORT_SENTINEL, trunc_div

DEFAULT_PROBE_DEPTH = 16

# Never-used slot key: no live voxel coordinate can equal it.
EMPTY_KEY = -(1 << 20)

# int16 full scale = one voxel size.
QSCALE = 32767.0

# Slot positions are part of a saved map; bump when hash_keys changes.
HASH_LAYOUT_VERSION = 3

_U32 = 0xFFFFFFFF
_I32_MAX = 2**31 - 1

# Dense-index geometry: 8 bits of x and y (a 256-voxel period), 6 of z
# (64 voxels); 2^22 cells of 8 bytes.
GRID_XY_BITS = 8
GRID_Z_BITS = 6
GRID_SIZE = 1 << (2 * GRID_XY_BITS + GRID_Z_BITS)


class InsertStats(NamedTuple):
    """Per-frame drop counters (0-dim int32): voxels beyond the unique
    capacity, new voxels whose probe window was full, and points beyond
    max_incoming_per_voxel in one voxel."""

    unique_overflow: torch.Tensor
    claim_failures: torch.Tensor
    incoming_truncated: torch.Tensor


class MapState(NamedTuple):
    keys: torch.Tensor  # int32 (C, 3)
    counts: torch.Tensor  # int32 (C,)
    points: torch.Tensor  # int16 (C, 4, K) planar quantized blocks
    first_pts: torch.Tensor  # f32 (C, 3)
    grid: torch.Tensor | None = None  # int32 (GRID_SIZE, 2) [slot | hi-check], slot -1 empty; None without the index

    @property
    def capacity(self) -> int:
        return self.counts.shape[0]

    @property
    def points_per_voxel(self) -> int:
        return self.points.shape[2]


def create(capacity: int, points_per_voxel: int, device=None, dtype=torch.float32,
           dense_grid: bool = False) -> MapState:
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"map capacity {capacity} is not a power of two")
    grid = None
    if dense_grid:
        grid = torch.zeros((GRID_SIZE + 1, 2), dtype=torch.int32, device=device)[:GRID_SIZE]
        grid[:, 0].fill_(-1)
    # each tensor the first rows of a buffer with a spare row (the
    # donated layout, has_spare), so a step can take the map as it is
    # and update it in place
    n = capacity + 1
    return MapState(
        keys=torch.full((n, 3), EMPTY_KEY, dtype=torch.int32, device=device)[:capacity],
        counts=torch.zeros((n,), dtype=torch.int32, device=device)[:capacity],
        points=torch.zeros((n, 4, points_per_voxel), dtype=torch.int16, device=device)[:capacity],
        first_pts=torch.full((n, 3), INVALID_COORD, dtype=dtype, device=device)[:capacity],
        grid=grid,
    )


def grid_index(keys: torch.Tensor) -> torch.Tensor:
    """Voxel coords (…, 3) int32 -> their torus cell (…,) int32: the low
    bits of each coordinate in two's complement."""
    xy, z = (1 << GRID_XY_BITS) - 1, (1 << GRID_Z_BITS) - 1
    return (((keys[..., 0] & xy) << (GRID_XY_BITS + GRID_Z_BITS)) | ((keys[..., 1] & xy) << GRID_Z_BITS)
            | (keys[..., 2] & z))


def grid_hi_code(keys: torch.Tensor) -> torch.Tensor:
    """Checksum (…,) int32 of the coordinate bits above the torus period
    (arithmetic shifts): hx*73856093 ^ hy*19349663 ^ hz*83492791 with
    int32 wraparound, computed in int64 and wrapped explicitly so that
    every device gives the same bits."""
    k = keys.to(torch.int64)
    h = ((k[..., 0] >> GRID_XY_BITS) * 73856093 ^ (k[..., 1] >> GRID_XY_BITS) * 19349663
         ^ (k[..., 2] >> GRID_Z_BITS) * 83492791) & _U32
    return torch.where(h > _I32_MAX, h - (1 << 32), h).to(torch.int32)


def grid_probe(state: MapState, query_keys: torch.Tensor):
    """Dense-index lookup of voxel keys (…, 3): (found, slot), the slot 0
    where not found. One 8-byte row gather and a checksum compare. A
    found slot's block is live: insert and remove_far clear a cell
    whenever its voxel leaves its slot."""
    g = state.grid[grid_index(query_keys).long()]
    slot = g[..., 0]
    found = (slot >= 0) & (g[..., 1] == grid_hi_code(query_keys))
    return found, torch.where(found, slot, 0)


def _grid_with_spare(grid: torch.Tensor) -> torch.Tensor:
    """A copy of the grid with one spare row at GRID_SIZE for the writes
    to drop: the one copy a functional update needs."""
    return torch.cat([grid, grid[:1]])


def set_rows(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor, write: torch.Tensor,
             in_place: bool = False) -> torch.Tensor:
    """Functional dst.at[idx].set(src) for the rows where `write` holds;
    the others are dropped (they land in a spare row that is cut off).
    in_place: dst is a donated map tensor, written in place, and returned."""
    n = dst.shape[0]
    out = _spare(dst) if in_place else torch.cat([dst, dst[:1]])
    out[torch.where(write, idx, n).long()] = src
    return out[:n]


def has_spare(t: torch.Tensor) -> bool:
    """Whether t is the first rows of a buffer with one spare row behind
    them (a map tensor that can be updated in place)."""
    base = t._base
    return (base is not None and base.data_ptr() == t.data_ptr() and t.is_contiguous()
            and base.numel() == (t.shape[0] + 1) * (t.numel() // max(t.shape[0], 1)))


def _spare(t: torch.Tensor) -> torch.Tensor:
    """The buffer behind a donated map tensor (has_spare): t's rows and one
    spare."""
    if not has_spare(t):
        raise ValueError("in_place needs a donated map (hashmap.create or with_spare): a tensor with a spare row "
                         "behind it")
    return t._base.view((t.shape[0] + 1, *t.shape[1:]))


def with_spare(t: torch.Tensor) -> torch.Tensor:
    """A copy of t as the first rows of a buffer with one spare row."""
    return torch.cat([t, t[:1]])[: t.shape[0]]


def copy_into(dst: MapState, src: MapState) -> None:
    """Overwrite dst's tensors with src's (same layout), in place."""
    if (dst.grid is None) != (src.grid is None):
        raise ValueError("copy_into: one map has the dense index and the other has not")
    for d, s in zip(dst, src):
        if d is not None:
            d.copy_(s)


def quantize_points(points: torch.Tensor, vkeys: torch.Tensor, voxel_size) -> torch.Tensor:
    """(…, 4) f32 world xyz+label -> (…, 4) int16 voxel-local + label.
    Rounds half to even (torch.round, like jnp.round)."""
    local = points[..., :3] - vkeys.to(points.dtype) * voxel_size
    q = torch.clamp(torch.round(local * (QSCALE / voxel_size)), -QSCALE, QSCALE).to(torch.int16)
    return torch.cat([q, points[..., 3:4].to(torch.int16)], dim=-1)


def dequantize_points(stored: torch.Tensor, vkeys: torch.Tensor, voxel_size, dtype=torch.float32):
    """Inverse of quantize_points: (…, 4) int16 -> (…, 4) f32 world."""
    xyz = stored[..., :3].to(dtype) * (voxel_size / QSCALE) + vkeys.to(dtype) * voxel_size
    return torch.cat([xyz, stored[..., 3:4].to(dtype)], dim=-1)


def dequantize_blocks(stored: torch.Tensor, vkeys: torch.Tensor, voxel_size, dtype=torch.float32):
    """(…, 4, K) int16 planes -> (…, K, 4) f32 world points."""
    xyz = stored[..., :3, :].to(dtype) * (voxel_size / QSCALE) + vkeys[..., :, None].to(dtype) * voxel_size
    lab = stored[..., 3:4, :].to(dtype)
    return torch.movedim(torch.cat([xyz, lab], dim=-2), -2, -1)


def probe_offset(d):
    """Triangular probe offset of round d: 0, 1, 3, 6, 10, ..."""
    return (d * (d + 1)) // 2


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h in [0, 2**32), without overflowing
    int64: the constant is split into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash_keys(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    """Spatial hash x*73856093 ^ y*19349663 ^ z*83492791 in uint32 with
    wraparound, then Fibonacci mixing (multiply by 2**32/phi, keep the
    high bits). uint32 arithmetic is emulated in int64 masked to 32 bits.
    (…, 3) int32 -> (…,) int32 slot."""
    k = keys.to(torch.int64) & _U32
    h = _mul_u32(k[..., 0], 73856093) ^ _mul_u32(k[..., 1], 19349663) ^ _mul_u32(k[..., 2], 83492791)
    bits = int(capacity).bit_length() - 1
    return (_mul_u32(h, 2654435769) >> (32 - bits)).to(torch.int32)


def lookup(state: MapState, query_keys: torch.Tensor, probe_depth: int = DEFAULT_PROBE_DEPTH) -> torch.Tensor:
    """Slot of each voxel key (…, 3), or -1 when absent."""
    cap = state.capacity
    h = hash_keys(query_keys, cap)
    offs = probe_offset(torch.arange(probe_depth, dtype=torch.int32, device=h.device))
    slots = (h[..., None] + offs) & (cap - 1)  # (…, D)
    cand = state.keys[slots.long()]  # (…, D, 3)
    match = torch.all(cand == query_keys[..., None, :], dim=-1)
    first = torch.argmax(match.to(torch.int8), dim=-1, keepdim=True)
    slot = torch.gather(slots, -1, first)[..., 0]
    return torch.where(match.any(dim=-1), slot, -1)


def _unique_voxels_of_points(points: torch.Tensor, valid: torch.Tensor, voxel_size):
    """Sort points by voxel (stable: scan order within a voxel survives).
    Returns (points_sorted (N,4), voxel_keys_sorted (N,3), head (N,),
    valid_sorted (N,))."""
    v = trunc_div(points[:, :3], voxel_size)
    vmin = torch.where(valid[:, None], v, 2**20).amin(dim=0)
    vo = torch.clamp(v - vmin, 0, 4095).to(torch.int64)  # 12 bits/axis
    key = (vo[:, 0] << 32) | (vo[:, 1] * 4096 + vo[:, 2])
    key = torch.where(valid, key, SORT_SENTINEL)
    skey, order = torch.sort(key, stable=True)
    pts_sorted = points[order]
    head = torch.ones_like(valid)
    head[1:] = skey[1:] != skey[:-1]
    return pts_sorted, trunc_div(pts_sorted[:, :3], voxel_size), head, skey != SORT_SENTINEL


def insert(
    state: MapState,
    points: torch.Tensor,
    valid: torch.Tensor,
    voxel_size,
    basic_points: int,
    basic_label_mask: torch.Tensor,
    max_incoming_per_voxel: int = 24,
    probe_depth: int = DEFAULT_PROBE_DEPTH,
    unique_voxel_capacity: int | None = None,
    tables=None,
    mesh=None,
    in_place: bool = False,
):
    """AddPoints with the reference's per-block retention policy.

    points (N, 4) world xyz+label; valid (N,); basic_label_mask (L,) bool,
    True for the basic-class labels. tables: the frame's ProbeTables
    (correspondence_fast), else the map is probed with `lookup`.
    Returns (new MapState, InsertStats). Never synchronises the host.
    in_place: `state` is a donated map, updated in place and returned.

    mesh (parallel.sharding.Mesh): the policy phase (the block and
    incoming gathers and the policy kernel) runs on this rank's U/n
    compact rows, and the updated rows are all-gathered for the
    write-back, which runs replicated. Rows are independent, so the
    result is exactly the single-device insert. U must be a multiple of
    128 * n (parallel.sharding.pad_config_for_mesh)."""
    cap = state.capacity
    kmax = state.points_per_voxel
    n = points.shape[0]
    dev = points.device
    U = n if unique_voxel_capacity is None else unique_voxel_capacity

    pts_sorted, vkeys, head, val_sorted = _unique_voxels_of_points(points, valid, voxel_size)

    # --- compact unique voxels ---------------------------------------------
    head_valid = head & val_sorted
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    u_rank = torch.cumsum(head_valid, 0, dtype=torch.int32) - 1
    head_pos = torch.full((U,), n, dtype=torch.int32, device=dev)
    head_pos = set_rows(head_pos, u_rank, pos, head_valid & (u_rank < U))
    hp_c = torch.clamp(head_pos, max=n - 1).long()
    ukeys = vkeys[hp_c]
    n_unique = head_valid.sum(dtype=torch.int32)
    u_live = torch.arange(U, device=dev) < torch.clamp(n_unique, max=U)
    # per-voxel incoming count: sorted valid points add into their segment
    seg_idx = torch.where(val_sorted & (u_rank < U), u_rank, U).long()
    seg_len = torch.zeros((U + 1,), dtype=torch.int32, device=dev)
    seg_len.index_add_(0, seg_idx, torch.ones_like(seg_idx, dtype=torch.int32))
    seg_len = seg_len[:U]

    # --- a slot per unique voxel: lookup, then claim rounds -----------------
    if state.grid is not None:
        found_u, slots_u = grid_probe(state, ukeys)
        slot_u = torch.where(u_live & found_u, slots_u, -1)
    elif tables is not None:
        from sage_icp_tpu_torch.ops import correspondence_fast as cf

        found_u, slots_u = cf.probe(tables, ukeys, cf.pack_rel(ukeys - tables.center[None, :]), probe_depth)
        slot_u = torch.where(u_live & found_u, slots_u, -1)
    else:
        slot_u = torch.where(u_live, lookup(state, ukeys, probe_depth), -1)
    need_claim = u_live & (slot_u < 0)
    h = hash_keys(ukeys, cap)
    # live slots cannot be claimed, nor can slots resolved this frame by
    # the lookup (a culled block revived in place keeps its key)
    pre = u_live & (slot_u >= 0)
    taken = torch.cat([state.counts > 0, torch.zeros(1, dtype=torch.bool, device=dev)])
    # index_fill_: a Python scalar assigned through an index would be
    # uploaded from the host
    taken.index_fill_(0, torch.where(pre, slot_u, cap).long(), True)
    uid = torch.arange(U, dtype=torch.int32, device=dev)
    claim = torch.empty((cap + 1,), dtype=torch.int32, device=dev)
    # All probe_depth rounds run: a round with nobody unresolved changes
    # nothing, and a fixed count keeps the host out of the loop (the
    # reference stops early through a data-dependent while_loop).
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
    grid = state.grid
    if grid is not None:
        # a re-claimed slot's previous owner (a culled voxel) may still
        # own a cell pointing here: clear it unless another voxel has
        # taken the cell since. Both reads come before any write, and the
        # clears before this frame's rows (a voxel may land in the cell
        # it clears).
        old_keys = state.keys[torch.where(newly, slot_u, 0).long()]
        had_owner = newly & torch.any(old_keys != EMPTY_KEY, dim=-1)
        t_old = grid_index(old_keys)
        still_ours = grid[t_old.long(), 0] == slot_u
    new_keys = set_rows(state.keys, slot_u, ukeys, newly, in_place)
    new_counts = set_rows(state.counts, slot_u, torch.zeros_like(slot_u), newly, in_place)

    if grid is not None:
        grid = _spare(grid) if in_place else _grid_with_spare(grid)
        # index_fill_: a Python scalar assigned through an index would be
        # uploaded from the host
        grid[:, 0].index_fill_(0, torch.where(had_owner & still_ours, t_old, GRID_SIZE).long(), -1)
        # distinct live voxels hold distinct cells (the culled span is
        # below the period), so these writes never collide
        t_new = torch.where(has_slot, grid_index(ukeys), GRID_SIZE).long()
        grid[t_new] = torch.stack([slot_u, grid_hi_code(ukeys)], dim=-1)
        grid = grid[:GRID_SIZE]

    stats = InsertStats(
        unique_overflow=torch.clamp(n_unique - U, min=0).to(torch.int32),
        claim_failures=(need_claim & (slot_u < 0)).sum(dtype=torch.int32),
        incoming_truncated=torch.where(
            u_live, torch.clamp(seg_len - max_incoming_per_voxel, min=0), 0
        ).sum(dtype=torch.int32),
    )

    # --- retention policy on the compact (U, 4, K) buffer of touched blocks
    num_labels = basic_label_mask.shape[0]
    Rmax = max_incoming_per_voxel
    lo, hi = 0, U
    if mesh is not None:
        if U % (128 * mesh.size):
            raise ValueError(f"insert_unique_capacity {U} must divide into 128-row tiles across {mesh.size} "
                             "ranks (parallel.sharding.pad_config_for_mesh)")
        lo, hi = mesh.row_range(U)
    slot_c = torch.where(has_slot, slot_u, 0)[lo:hi].long()
    points2 = state.points.reshape(cap, 4 * kmax)
    compact = points2[slot_c].reshape(hi - lo, 4, kmax)
    ccounts = new_counts[slot_c]
    lab_s = torch.clamp(pts_sorted[:, 3].to(torch.int32), 0, num_labels - 1)
    cls_s = torch.where(lab_s == 0, 0, torch.where(basic_label_mask[lab_s.long()], 1, 2))
    pq_all = quantize_points(pts_sorted, vkeys, voxel_size)
    enc = (lab_s | (cls_s << policy_kernel.CLS_SHIFT)).to(torch.int16)
    # rank r of row u is sorted point head_pos[u] + r (wrapping; ranks at
    # or beyond the row's seglen are never read)
    win = (hp_c[lo:hi, None] + torch.arange(Rmax, device=dev)[None, :]) % n
    seglen = torch.where(has_slot, torch.clamp(seg_len, max=Rmax), 0)[lo:hi, None].contiguous()
    bx, by, bz, bl, cnt2 = policy_kernel.apply_policy(
        compact[:, 0].contiguous(), compact[:, 1].contiguous(),
        compact[:, 2].contiguous(), compact[:, 3].contiguous(),
        ccounts[:, None].contiguous(), seglen,
        pq_all[:, 0][win], pq_all[:, 1][win], pq_all[:, 2][win], enc[win],
        basic=basic_points,
    )
    compact = torch.stack([bx, by, bz, bl], dim=1)
    if mesh is not None:
        compact, cnt2 = _gather_rows(mesh, compact, cnt2)
    out = _insert_writeback(
        state, points2, compact, cnt2[:, 0], has_slot, slot_u, ukeys,
        new_keys, new_counts, grid, voxel_size, cap, kmax, U, in_place,
    )
    return out, stats


def _gather_rows(mesh, compact: torch.Tensor, counts: torch.Tensor):
    """All-gather this rank's policy rows, (U/n, 4, K) int16 blocks and
    (U/n, 1) int32 counts, into (U, 4, K) and (U, 1) in rank order. Both
    travel as the bytes of one (U/n, 8K + 4) uint8 buffer: one collective,
    and NCCL has no int16 type."""
    rows, _, kmax = compact.shape
    packed = torch.cat([compact.reshape(rows, 4 * kmax).view(torch.uint8), counts.view(torch.uint8)], dim=1)
    packed = mesh.all_gather(packed)
    blocks = packed[:, : 8 * kmax].contiguous().view(torch.int16).reshape(-1, 4, kmax)
    return blocks, packed[:, 8 * kmax :].contiguous().view(torch.int32)


def _insert_writeback(state, points2, compact, ccounts, has_slot, slot_u, ukeys,
                      new_keys, new_counts, grid, voxel_size, cap, kmax, U, in_place=False) -> MapState:
    """Write the policy-updated blocks back (slots are unique across live
    rows). The label plane is sanitised on the way out: lanes at or
    beyond the block's count get label -1, so the correspondence search
    reads per-lane validity straight from storage."""
    kidx = torch.arange(kmax, device=compact.device)
    lab_plane = torch.where(kidx[None, :] < ccounts[:, None], compact[:, 3, :], -1).to(torch.int16)
    compact = torch.cat([compact[:, :3, :], lab_plane[:, None, :]], dim=1)
    if in_place:
        set_rows(points2, slot_u, compact.reshape(U, 4 * kmax), has_slot, True)
        new_points = state.points
    else:
        new_points = set_rows(points2, slot_u, compact.reshape(U, 4 * kmax), has_slot).reshape(cap, 4, kmax)
    new_counts = set_rows(new_counts, slot_u, ccounts, has_slot, in_place)
    dt = state.first_pts.dtype
    first_world = compact[:, :3, 0].to(dt) * (voxel_size / QSCALE) + ukeys.to(dt) * voxel_size
    new_first = set_rows(state.first_pts, slot_u, first_world, has_slot, in_place)
    return MapState(keys=new_keys, counts=new_counts, points=new_points, first_pts=new_first, grid=grid)


def remove_far(state: MapState, origin: torch.Tensor, max_distance, in_place: bool = False) -> MapState:
    """Erase blocks whose FIRST point lies farther than max_distance from
    origin: count 0, key EMPTY_KEY, first point INVALID_COORD, so no
    probe can match the stale block again; the dense index's cell of each
    killed block is cleared while the block still owns it. in_place:
    `state` is a donated map, updated in place and returned."""
    d = state.first_pts - origin[None, :]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    kill = (state.counts > 0) & (d2 > max_distance * max_distance)
    killn = kill[:, None]
    grid = state.grid
    if grid is not None:
        t = grid_index(state.keys)
        still = grid[t.long(), 0] == torch.arange(state.capacity, dtype=torch.int32, device=t.device)
        grid = _spare(grid) if in_place else _grid_with_spare(grid)
        grid[:, 0].index_fill_(0, torch.where(kill & still, t, GRID_SIZE).long(), -1)
        grid = grid[:GRID_SIZE]
    if in_place:
        state.counts.masked_fill_(kill, 0)
        state.keys.masked_fill_(killn, EMPTY_KEY)
        state.first_pts.masked_fill_(killn, INVALID_COORD)
        return state
    return state._replace(
        counts=torch.where(kill, 0, state.counts),
        keys=torch.where(killn, EMPTY_KEY, state.keys),
        first_pts=torch.where(killn, INVALID_COORD, state.first_pts),
        grid=grid,
    )


def clear(state: MapState) -> MapState:
    """An empty map of the same capacity, block size, dtype, device and
    dense index (or none)."""
    return create(state.capacity, state.points_per_voxel, state.counts.device, state.first_pts.dtype,
                  dense_grid=state.grid is not None)


def is_empty(state: MapState) -> torch.Tensor:
    """0-dim bool: no live block."""
    return ~torch.any(state.counts > 0)


def pointcloud(state: MapState, voxel_size):
    """All stored points, world frame: ((C*K, 4), (C*K,) live mask)."""
    kidx = torch.arange(state.points_per_voxel, device=state.counts.device)
    mask = kidx[None, :] < state.counts[:, None]
    world = dequantize_blocks(state.points, state.keys, voxel_size)
    return world.reshape(-1, 4), mask.reshape(-1)


# 27-neighbourhood offsets, lane order i-major (the reference's loop
# order); correspondence rows lay their candidate blocks out in it.
NEIGHBOR_OFFSETS = [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


def neighbor_offsets(device=None) -> torch.Tensor:
    """(27, 3) int32, built once per device (ops/constants.py)."""
    return device_constant(NEIGHBOR_OFFSETS, torch.int32, device)


def get_correspondences(state: MapState, query, valid, voxel_size, max_correspondence_distance,
                        sem_th, probe_depth: int = DEFAULT_PROBE_DEPTH):
    """Reference-shaped semantic NN over the 27 neighbouring voxels.
    query (N, 4) -> (target (N, 4), accept (N,)). Arg-min on the
    sem_th-scaled squared distance (labels equal or either 0), acceptance
    on the unweighted distance."""
    kmax = state.points_per_voxel
    v = trunc_div(query[:, :3], voxel_size)
    nb = v[:, None, :] + neighbor_offsets(query.device)[None]  # (N, 27, 3)
    slots = lookup(state, nb, probe_depth)
    found = slots >= 0
    safe = torch.where(found, slots, 0).long()
    cand = dequantize_blocks(state.points[safe], nb, voxel_size, query.dtype)  # (N,27,K,4)
    cnt = state.counts[safe]
    kidx = torch.arange(kmax, device=query.device)
    cmask = found[..., None] & (kidx[None, None, :] < cnt[..., None])

    diff = cand[..., :3] - query[:, None, None, :3]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    ql = query[:, 3].to(torch.int32)[:, None, None]
    cl = cand[..., 3].to(torch.int32)
    sem = (cl == ql) | (cl * ql == 0)
    d2w = torch.where(sem, d2 * sem_th, d2)
    d2w = torch.where(cmask, d2w, torch.finfo(d2.dtype).max)

    N = query.shape[0]
    best = torch.argmin(d2w.reshape(N, -1), dim=-1)
    any_cand = cmask.reshape(N, -1).any(dim=-1)
    tgt = cand.reshape(N, -1, 4)[torch.arange(N, device=query.device), best]
    d2_true = d2.reshape(N, -1)[torch.arange(N, device=query.device), best]
    accept = valid & any_cand & (torch.sqrt(d2_true) < max_correspondence_distance)
    return tgt, accept
