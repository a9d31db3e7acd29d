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
from sage_icp_tpu_torch.ops.constants import device_constant

# Sentinel coordinate of invalid points: far outside any map.
INVALID_COORD = 1.0e7

# Above every valid packed (key_hi << 32 | key_lo) sort key; invalid
# points sort last.
SORT_SENTINEL = 1 << 62


def trunc_div(x: torch.Tensor, s) -> torch.Tensor:
    """C-style int cast of x / s (truncation toward zero).

    A Python scalar divisor becomes a tensor on x's device first (built
    once, ops/constants.py): CUDA computes `tensor / cpu_scalar` as a
    multiply by the reciprocal, which can land one ulp off the true
    quotient and flip a voxel index."""
    if not torch.is_tensor(s):
        s = device_constant(float(s), x.dtype, x.device)
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


# Below this angle (rad) deskew takes its coefficients by their series:
# float32's closed forms (1 - cos t) / t^2 and (t - sin t) / t^3 cancel
# to 0 near 4e-4 and 8e-4 rad, where a cruising vehicle's points turn.
# The series through t^4 is exact in float32 up to here (its next terms
# are below 1e-9); benchmark/reference/deskew.py switches at the same
# angle.
SERIES_BELOW = 0.1


def _series(theta2, c0: float, c2: float, c4: float):
    """c0 + c2 t^2 + c4 t^4, Horner's rule on t^2, each step one float32
    product or sum (the card and the CPU round each alike)."""
    return c0 + theta2 * (c2 + theta2 * c4)


def deskew(points, timestamps, start_pose, finish_pose):
    """points (N, 4) xyz+label, timestamps (N,) in [0, 1], start/finish
    (4, 4) poses -> (N, 4), xyz moved by exp((t - 0.5) * delta),
    delta = log(start^-1 finish), in float32.

    Each point's exponential is written out element by element (the
    Rodrigues and V coefficients a = sin t / t, b = (1 - cos t) / t^2 and
    c = (t - sin t) / t^3, by their series below SERIES_BELOW; hat(phi)^2 =
    phi phi^T - |phi|^2 I, its diagonal summed in float64 and rounded
    once), and the point moved as p + (R - I) p + V rho: the six products
    of float32 values exact in float64, summed there with p and rounded
    once, so a point 100 m out lies within float32's spacing of the exact
    deskew. No batched matrix product: a point's result does not depend on
    the batch it is in (a rank's share of the scan gives the bits of the
    whole scan), and for the same delta the card and the CPU give the same
    bits (delta's 4x4 product and log may round apart on the two: one
    float32 step of a point 100 m out, seen on an H100).

    The JAX package takes b and c in float32's closed forms from 1e-4 rad
    on (sage_icp_tpu/ops/geometry.py se3_exp), where they cancel: its
    points lie up to 6e-5 m from the exact deskew at a cruising vehicle's
    angles. This deskew departs from it there, and stays within float32's
    resolution of the exact one (tests/test_torch_deskew_chunk.py)."""
    delta = geo.se3_log(geo.se3_inverse(start_pose) @ finish_pose)  # (6,)
    s = timestamps - 0.5
    rho = [s * delta[i] for i in range(3)]
    phi = [s * delta[3 + i] for i in range(3)]
    theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2]
    theta = torch.sqrt(theta2 + geo._EPS * geo._EPS)
    small = theta < SERIES_BELOW
    sin_t = geo._sin(theta)
    a = torch.where(small, _series(theta2, 1.0, -1.0 / 6.0, 1.0 / 120.0), sin_t / theta)
    b = torch.where(small, _series(theta2, 0.5, -1.0 / 24.0, 1.0 / 720.0), (1.0 - geo._cos(theta)) / theta2)
    c = torch.where(small, _series(theta2, 1.0 / 6.0, -1.0 / 120.0, 1.0 / 5040.0), (theta - sin_t) / (theta2 * theta))
    K = [[None, -phi[2], phi[1]], [phi[2], None, -phi[0]], [-phi[1], phi[0], None]]  # hat(phi)
    d = [p.to(torch.float64) for p in phi]
    KK = [[phi[i] * phi[j] for j in range(3)] for i in range(3)]
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        KK[i][i] = (-(d[j] * d[j] + d[k] * d[k])).to(torch.float32)
    # R - I = a K + b K^2 and V = I + b K + c K^2: K's diagonal is 0
    R = [[b * KK[i][j] if i == j else a * K[i][j] + b * KK[i][j] for j in range(3)] for i in range(3)]
    V = [[1.0 + c * KK[i][j] if i == j else b * K[i][j] + c * KK[i][j] for j in range(3)] for i in range(3)]
    terms = [x.to(torch.float64) for x in [points[:, 0], points[:, 1], points[:, 2], *rho]]
    out = []
    for i in range(3):
        acc = terms[i]
        for coef, x in zip(R[i] + V[i], terms):
            acc = acc + coef.to(torch.float64) * x
        out.append(acc.to(torch.float32))
    return torch.cat([torch.stack(out, dim=-1), points[:, 3:]], dim=-1)


def make_label_group_lut(voxel_labels, num_labels: int = 260, device=None) -> torch.Tensor:
    """label -> class-group id; -1 = in no group (dropped by the
    downsampler). Built once per device (ops/constants.py)."""
    lut = [-1] * num_labels
    for g, labels in enumerate(voxel_labels):
        for lab in labels:
            lut[lab] = g
    return device_constant(lut, torch.int32, device)


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
