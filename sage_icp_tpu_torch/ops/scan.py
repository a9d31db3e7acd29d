"""Scan-level ops: range crop, label-range masking, deskew and
class-adaptive voxel downsampling, fixed-shape and masked like the JAX
reference.

  * preprocess keeps min_range < ||p|| < max_range and zeroes labels
    beyond label_max_range; dropped points move to INVALID_COORD and
    carry valid = False (the shape never changes).
  * deskew is constant-velocity motion compensation: each point moves by
    exp((t - 0.5) * log(start^-1 finish)) for its sweep phase t in [0, 1]
    (reference core/Deskew.cpp:36-50).
  * voxel_downsample keeps the FIRST point in scan order of every
    (class group, voxel) cell, one grid per class group at that group's
    voxel size times vox_scale; labels in no group are dropped.

Voxel coordinates truncate toward zero (C's static_cast<int>), not floor.
"""

from __future__ import annotations

import torch

from sage_icp_tpu_torch.ops import geometry as geo

# Sentinel coordinate of invalid points: far outside any map.
INVALID_COORD = 1.0e7

# Above every valid packed (key_hi << 32 | key_lo) sort key; invalid
# points sort last.
SORT_SENTINEL = 1 << 62


def trunc_div(x: torch.Tensor, s) -> torch.Tensor:
    """C-style int cast of x / s (truncation toward zero).

    A Python scalar divisor becomes a tensor on x's device first: CUDA
    computes `tensor / cpu_scalar` as a multiply by the reciprocal, which
    can land one ulp off the true quotient and flip a voxel index."""
    if not torch.is_tensor(s):
        s = torch.tensor(s, dtype=x.dtype, device=x.device)
    return torch.trunc(x / s).to(torch.int32)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of the last (size-3) axis, summed in x, y, z order."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def preprocess(points, valid, max_range: float, min_range: float, label_max_range: float):
    """points (N, 4) xyz+label, valid (N,) bool -> (points', valid')."""
    norm = norm3(points[:, :3])
    keep = valid & (norm < max_range) & (norm > min_range)
    label = torch.where(norm > label_max_range, torch.zeros_like(points[:, 3]), points[:, 3])
    pts = torch.cat([points[:, :3], label[:, None]], dim=-1)
    pts = torch.where(keep[:, None], pts, torch.full_like(pts, INVALID_COORD))
    return pts, keep


def deskew(points, timestamps, start_pose, finish_pose):
    """points (N, 4) xyz+label, timestamps (N,) in [0, 1], start/finish
    (4, 4) poses -> (N, 4), xyz moved by exp((t - 0.5) * delta),
    delta = log(start^-1 finish), all in float32 as in the reference.

    The rotation is applied as the reference's einsum rounds it on the
    CPU, a fused multiply-add chain fma(R2, z, fma(R1, y, R0 * x)), then
    + t. Each fused step is one float64 product and sum (the product of
    two float32 values is exact there) rounded to float32, so the card and
    the CPU give the same bits."""
    delta = geo.se3_log(geo.se3_inverse(start_pose) @ finish_pose)  # (6,)
    T = geo.se3_exp((timestamps - 0.5)[:, None] * delta[None, :])  # (N, 4, 4)
    R = T[:, :3, :3].to(torch.float64)
    p = points[:, :3].to(torch.float64)
    acc = (R[:, :, 0] * p[:, 0:1]).to(torch.float32)
    acc = (acc.to(torch.float64) + R[:, :, 1] * p[:, 1:2]).to(torch.float32)
    acc = (acc.to(torch.float64) + R[:, :, 2] * p[:, 2:3]).to(torch.float32)
    return torch.cat([acc + T[:, :3, 3], points[:, 3:]], dim=-1)


def make_label_group_lut(voxel_labels, num_labels: int = 260, device=None) -> torch.Tensor:
    """label -> class-group id; -1 = in no group (dropped by the
    downsampler)."""
    lut = torch.full((num_labels,), -1, dtype=torch.int32, device=device)
    for g, labels in enumerate(voxel_labels):
        for lab in labels:
            lut[lab] = g
    return lut


def label_in_set(labels_i32: torch.Tensor, wanted) -> torch.Tensor:
    hit = torch.zeros(labels_i32.shape, dtype=torch.bool, device=labels_i32.device)
    for lab in wanted:
        hit = hit | (labels_i32 == lab)
    return hit


# Up to this many labels in all groups, a chain of compares; beyond, a
# table lookup with labels clipped into the table (the reference's rule,
# which decides where out-of-range labels go).
_COMPARE_CHAIN_MAX = 48


def label_groups(labels_i32: torch.Tensor, voxel_labels) -> torch.Tensor:
    """Per-point class-group id (-1 = none); a later group wins."""
    if sum(len(g) for g in voxel_labels) > _COMPARE_CHAIN_MAX:
        lut = make_label_group_lut(voxel_labels, device=labels_i32.device)
        return lut[torch.clamp(labels_i32, 0, lut.shape[0] - 1).long()]
    group = torch.full(labels_i32.shape, -1, dtype=torch.int32, device=labels_i32.device)
    for g, labs in enumerate(voxel_labels):
        group = torch.where(label_in_set(labels_i32, labs), g, group)
    return group


def compact_rows(rows: torch.Tensor, keep: torch.Tensor, capacity: int, fill: float):
    """Stable compaction without a host sync: kept rows of `rows` in
    order to the front of a (capacity, C) buffer, the rest `fill`.
    Returns (out, n_keep) with n_keep a 0-dim device tensor."""
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    dest = torch.where(keep & (rank < capacity), rank, capacity)
    out = torch.full((capacity + 1, rows.shape[1]), fill, dtype=rows.dtype, device=rows.device)
    out[dest] = rows  # every dropped row lands in the spare last row
    return out[:capacity], rank[-1] + 1 if rows.shape[0] else rank.new_zeros(())


def voxel_downsample(
    points: torch.Tensor,
    valid: torch.Tensor,
    voxel_labels,
    voxel_sizes: torch.Tensor,
    vox_scale: float,
    out_capacity: int,
):
    """Class-adaptive downsample keeping the first point per cell.

    points (N, 4); valid (N,); voxel_labels: the class groups' label
    sets; voxel_sizes (G,) f32 per-group base size. Returns
    (out_points (out_capacity, 4), out_valid (out_capacity,),
    truncated: kept cells beyond out_capacity, 0-dim int32)."""
    label = points[:, 3].to(torch.int32)
    group = torch.where(valid, label_groups(label, voxel_labels), -1)
    in_group = group >= 0
    g_safe = torch.clamp(group, min=0)
    sizes = voxel_sizes[g_safe.long()] * vox_scale
    v = trunc_div(points[:, :3], sizes[:, None])

    # (group, voxel) -> one int64 key: hi = group|x, lo = y|z, 11 bits
    # per axis (coords clamp to +-1023)
    vc = (torch.clamp(v, -1023, 1023) + 1024).to(torch.int64)
    key = ((g_safe.to(torch.int64) * 2048 + vc[:, 0]) << 32) | (vc[:, 1] * 2048 + vc[:, 2])
    key = torch.where(in_group, key, SORT_SENTINEL)
    # stable: "keep the first point" is the first in scan order
    skey, order = torch.sort(key, stable=True)
    spts = points[order]
    head = torch.ones_like(in_group)
    head[1:] = skey[1:] != skey[:-1]
    keep = head & (skey != SORT_SENTINEL)

    out_pts, n_keep = compact_rows(spts, keep, out_capacity, INVALID_COORD)
    out_val = torch.arange(out_capacity, device=points.device) < n_keep
    truncated = torch.clamp(n_keep - out_capacity, min=0).to(torch.int32)
    return out_pts, out_val, truncated
