"""Scan-level work of the reference step: the range crop, the label
groups and the class-adaptive voxel downsample (the first point in scan
order of each (class group, voxel) cell), on fixed-capacity tensors.
Voxel coordinates truncate toward zero, as C's static_cast<int> does."""

from __future__ import annotations

import torch

INVALID_COORD = 1.0e7  # coordinate of an invalid row: far outside any map
SORT_SENTINEL = 1 << 62  # above every valid packed sort key

_CONSTANTS: dict = {}


def const(value, dtype, device) -> torch.Tensor:
    """A constant tensor on `device`, made once. A Python scalar divisor
    on a CUDA tensor is a multiply by its reciprocal, which can land one
    ulp off the true quotient: divisors go through here."""
    key = (tuple(value) if isinstance(value, (list, tuple)) else value, dtype, str(device))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.tensor(value, dtype=dtype, device=device)
    return _CONSTANTS[key]


def trunc_div(x: torch.Tensor, s) -> torch.Tensor:
    if not torch.is_tensor(s):
        s = const(float(s), x.dtype, x.device)
    return torch.trunc(x / s).to(torch.int32)


def norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def preprocess(points, valid, max_range: float, min_range: float, label_max_range: float):
    """Keep min_range < |p| < max_range; labels beyond label_max_range
    become 0; dropped rows move to INVALID_COORD."""
    norm = norm3(points[:, :3])
    keep = valid & (norm < max_range) & (norm > min_range)
    label = torch.where(norm > label_max_range, torch.zeros_like(points[:, 3]), points[:, 3])
    pts = torch.cat([points[:, :3], label[:, None]], dim=-1)
    return torch.where(keep[:, None], pts, torch.full_like(pts, INVALID_COORD)), keep


def label_in_set(labels_i32: torch.Tensor, wanted) -> torch.Tensor:
    hit = torch.zeros(labels_i32.shape, dtype=torch.bool, device=labels_i32.device)
    for lab in wanted:
        hit = hit | (labels_i32 == lab)
    return hit


def label_groups(labels_i32: torch.Tensor, voxel_labels) -> torch.Tensor:
    """Class group of each label (-1 = none); a later group wins."""
    group = torch.full(labels_i32.shape, -1, dtype=torch.int32, device=labels_i32.device)
    for g, labs in enumerate(voxel_labels):
        group = torch.where(label_in_set(labels_i32, labs), g, group)
    return group


def compact_rows(rows: torch.Tensor, keep: torch.Tensor, capacity: int, fill: float):
    """Kept rows in order to the front of a (capacity, C) buffer, the rest
    `fill`; returns (buffer, kept count as a 0-dim tensor)."""
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    dest = torch.where(keep & (rank < capacity), rank, capacity)
    out = torch.full((capacity + 1, rows.shape[1]), fill, dtype=rows.dtype, device=rows.device)
    out[dest] = rows
    return out[:capacity], rank[-1] + 1


def voxel_downsample(points, valid, voxel_labels, voxel_sizes: torch.Tensor, vox_scale: float, out_capacity: int):
    """(out_points (cap, 4), out_valid (cap,), cells beyond the capacity)."""
    label = points[:, 3].to(torch.int32)
    group = torch.where(valid, label_groups(label, voxel_labels), -1)
    in_group = group >= 0
    g_safe = torch.clamp(group, min=0)
    sizes = voxel_sizes[g_safe.long()] * vox_scale
    v = trunc_div(points[:, :3], sizes[:, None])
    vc = (torch.clamp(v, -1023, 1023) + 1024).to(torch.int64)
    key = ((g_safe.to(torch.int64) * 2048 + vc[:, 0]) << 32) | (vc[:, 1] * 2048 + vc[:, 2])
    key = torch.where(in_group, key, SORT_SENTINEL)
    skey, order = torch.sort(key, stable=True)
    spts = points[order]
    head = torch.ones_like(in_group)
    head[1:] = skey[1:] != skey[:-1]
    keep = head & (skey != SORT_SENTINEL)
    out_pts, n_keep = compact_rows(spts, keep, out_capacity, INVALID_COORD)
    out_val = torch.arange(out_capacity, device=points.device) < n_keep
    return out_pts, out_val, torch.clamp(n_keep - out_capacity, min=0).to(torch.int32)
