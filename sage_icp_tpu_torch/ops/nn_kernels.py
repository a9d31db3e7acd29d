"""Nearest-neighbour kernels over candidate rows: the CUDA kernels
(csrc/semantic_nn.cu, csrc/gn_iteration.cu, csrc/radius_count.cu) and
their plain PyTorch versions.

They replace the TPU kernels sage_icp_tpu/ops/pallas_nn.py::
fused_semantic_nn, ::fused_gn_iteration and ::radius_count. A
correspondence row (see correspondence_fast.corr_setup) holds M = 27 * K
candidate lanes as int16 voxel-local planes plus an int16 label plane
(-1 = invalid lane), and P query slots. Per slot the selection takes the
FIRST lane minimising the squared distance, scaled by sem_th where the
labels match or either is 0; invalid lanes never beat a valid one.
Coordinates are row-local (relative to the row's voxel origin), where
float32 is exact enough. radius_count (the dynamic-vehicle filter's
landmark test) counts, per query slot, the float32 candidate lanes of its
row within a radius.

Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors (or raises); there is no other switch.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from sage_icp_tpu_torch.ops import cuda_lib
from sage_icp_tpu_torch.ops.scan import trunc_div

BIG_D2 = 1.0e12  # true d2 reported for an invalid winner: fails any gate
N_SUMS = 18  # w, w*s(3), w*s_i*s_j(6), w*r(3), w*(s x r)(3), ncorr, used
TILE_ROWS = 128  # rows per tile of the tile_map dead-tile rule
SUPPORTED_P = (1, 2, 4, 8)

_F = ctypes.c_float
_V = ctypes.c_void_p
_I = ctypes.c_int
_NN_ARGTYPES = [_V] * 8 + [_I, _I, _I, _F, _F] + [_V] * 6
_GN_ARGTYPES = [_V] * 12 + [_I, _V, _I, _I, _I, _F, _F, _F, _F, _F, _V, _V, _V, _V]
_RC_ARGTYPES = [_V] * 5 + [_I, _I, _I, _F, _F, _V, _V]
RC_MAX_SMEM = 232_448  # shared memory one block may take on an H100


def _check_rows(cx, cy, cz, cl, offx, offy, offz, P):
    R, M = cx.shape
    if P not in SUPPORTED_P:
        raise ValueError(f"P = {P} query slots per row; the kernels take {SUPPORTED_P}")
    for name, t in (("cx", cx), ("cy", cy), ("cz", cz), ("cl", cl)):
        cuda_lib.check_cuda(name, t, torch.int16, (R, M))
    for name, t in (("offx", offx), ("offy", offy), ("offz", offz)):
        cuda_lib.check_cuda(name, t, torch.float32, (1, M))
    return R, M


def _dequant(cx, cy, cz, cl, offx, offy, offz, scale):
    """(R, M) row-local candidate planes and the invalid-lane mask."""
    cxf = cx.to(torch.float32) * scale + offx
    cyf = cy.to(torch.float32) * scale + offy
    czf = cz.to(torch.float32) * scale + offz
    clf = cl.to(torch.float32)
    return cxf, cyf, czf, clf, clf < 0.0


def _select(cxf, cyf, czf, clf, invalid, qx, qy, qz, ql, sem_th):
    """(R, P) first-minimum winners for (R, P) row-local queries, and the
    (R, P, M) unweighted squared distances."""
    dx = cxf[:, None, :] - qx[..., None]
    dy = cyf[:, None, :] - qy[..., None]
    dz = czf[:, None, :] - qz[..., None]
    d2 = dx * dx + dy * dy + dz * dz
    c = clf[:, None, :]
    q = ql[..., None]
    sem = (c == q) | ((c * q) == 0.0)
    d2w = torch.where(sem, d2 * sem_th, d2)
    d2w = torch.where(invalid[:, None, :], torch.finfo(torch.float32).max, d2w)
    return torch.argmin(d2w, dim=-1), d2


def fused_semantic_nn(cx, cy, cz, cl, offx, offy, offz, queries, sem_th, scale):
    """cx/cy/cz/cl (R, M) int16; offx/offy/offz (1, M) f32 per-lane
    neighbour offsets in metres; queries (R, 4P) f32 [x y z label],
    row-local. Returns (tx, ty, tz, tl, d2), each (R, P) f32: the winner's
    row-local xyz and label and its UNWEIGHTED squared distance (BIG_D2
    for an invalid winner); the caller applies the acceptance gate."""
    if cuda_lib.on_cpu(cx):
        return fused_semantic_nn_plain(cx, cy, cz, cl, offx, offy, offz, queries, sem_th, scale)
    P = queries.shape[1] // 4
    R, M = _check_rows(cx, cy, cz, cl, offx, offy, offz, P)
    cuda_lib.check_cuda("queries", queries, torch.float32, (R, 4 * P))
    outs = [torch.empty((R, P), dtype=torch.float32, device=cx.device) for _ in range(5)]
    fn = cuda_lib.function("semantic_nn.cu", "sage_semantic_nn", _NN_ARGTYPES)
    p = cuda_lib.ptr
    cuda_lib.call(
        "fused_semantic_nn", fn,
        p(cx), p(cy), p(cz), p(cl), p(offx), p(offy), p(offz), p(queries),
        R, M, P, float(sem_th), float(scale), *[p(o) for o in outs],
        cuda_lib.stream_ptr(cx.device),
    )
    return tuple(outs)


def fused_semantic_nn_plain(cx, cy, cz, cl, offx, offy, offz, queries, sem_th, scale):
    R = cx.shape[0]
    q = queries.reshape(R, -1, 4)
    cxf, cyf, czf, clf, invalid = _dequant(cx, cy, cz, cl, offx, offy, offz, scale)
    best, d2 = _select(cxf, cyf, czf, clf, invalid, q[..., 0], q[..., 1], q[..., 2], q[..., 3], sem_th)
    d2 = torch.where(invalid[:, None, :], BIG_D2, d2)
    return (
        torch.gather(cxf, 1, best), torch.gather(cyf, 1, best), torch.gather(czf, 1, best),
        torch.gather(clf, 1, best), torch.gather(d2, 2, best[..., None])[..., 0],
    )


def default_tile_map(used: torch.Tensor) -> torch.Tensor:
    """Live tiles map to themselves, tiles without a used slot to tile 0
    (the JAX reference's dead-tile redirect)."""
    R = used.shape[0]
    n_tiles = -(-R // TILE_ROWS)
    pad = torch.zeros((n_tiles * TILE_ROWS - R, used.shape[1]), dtype=used.dtype, device=used.device)
    live = torch.cat([used, pad]).reshape(n_tiles, -1).ne(0).any(dim=1)
    return torch.where(live, torch.arange(n_tiles, dtype=torch.int32, device=used.device), 0).to(torch.int32)


def gn_load_bytes(M: int) -> int:
    """Bytes the GN kernel reads per lane and plane in one load for rows
    of M int16 lanes: 16 when the row stride 2M allows it, else 8, else 2
    (csrc/gn_iteration.cu load_width)."""
    return 16 if (2 * M) % 16 == 0 else 8 if (2 * M) % 8 == 0 else 2


# csrc/gn_iteration.cu kMaxBlocks: the GN grid is min(ceil(R / 8), this)
# blocks, fixed by R alone, each writing one partial row
GN_MAX_BLOCKS = 528
# per device index: the ticket counter (zero between calls) and the
# partial rows of the GN kernel
_gn_scratch: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def _gn_scratch_on(dev):
    if dev.index not in _gn_scratch:
        _gn_scratch[dev.index] = (torch.zeros((1,), dtype=torch.int32, device=dev),
                                  torch.empty((GN_MAX_BLOCKS, N_SUMS), dtype=torch.float32, device=dev))
    return _gn_scratch[dev.index]


def fused_gn_iteration(cx, cy, cz, cl, offx, offy, offz, q0, origin, row_abs, used, T,
                       sem_th, scale, voxel_size, max_corr, kernel_th, tile_map=None):
    """One fused Gauss-Newton iteration over the frozen rows.

    q0 (R, 4P) f32 setup queries [x y z label], world frame; origin (R, 3)
    f32 row voxel origins; row_abs (R, 3) int32 absolute row voxels; used
    (R, P) int32; T (4, 4) f32 pose increment since setup, read on the
    host (a CUDA T is brought over with .cpu(); the ICP loop keeps it on
    the host); tile_map (ceil(R / TILE_ROWS),) int32, default_tile_map(used)
    when None. Returns the (18,) f32 sums in N_SUMS order (deterministic).
    On the card the call is one launch; its scratch (a ticket counter and
    the blocks' partial rows) is cached per device, so calls on one device
    run in stream order on one stream."""
    if tile_map is None:
        tile_map = default_tile_map(used)
    if cuda_lib.on_cpu(cx):
        return gn_terms(cx, cy, cz, cl, offx, offy, offz, q0, origin, row_abs, used, T,
                        sem_th, scale, voxel_size, max_corr, kernel_th, tile_map).sum(dim=1)
    dev = cx.device
    P = used.shape[1]
    R, M = _check_rows(cx, cy, cz, cl, offx, offy, offz, P)
    cuda_lib.check_cuda("q0", q0, torch.float32, (R, 4 * P))
    cuda_lib.check_cuda("origin", origin, torch.float32, (R, 3))
    cuda_lib.check_cuda("row_abs", row_abs, torch.int32, (R, 3))
    cuda_lib.check_cuda("used", used, torch.int32, (R, P))
    cuda_lib.check_cuda("tile_map", tile_map, torch.int32, (-(-R // TILE_ROWS),))
    width = gn_load_bytes(M)
    for name, t in (("cx", cx), ("cy", cy), ("cz", cz), ("cl", cl)):
        if t.data_ptr() % width:
            raise ValueError(f"{name}: the kernel reads rows of {M} lanes {width} B at a time; "
                             f"the base address must be {width}-byte aligned")
    T = T.detach().to("cpu", torch.float32)
    if tuple(T.shape) != (4, 4):
        raise ValueError(f"T: expected (4, 4), got {tuple(T.shape)}")
    t12 = (_F * 12)(*T[:3].reshape(-1).tolist())
    counter, partials = _gn_scratch_on(dev)
    out = torch.empty((N_SUMS,), dtype=torch.float32, device=dev)
    fn = cuda_lib.function("gn_iteration.cu", "sage_gn_iteration", _GN_ARGTYPES)
    p = cuda_lib.ptr
    cuda_lib.call(
        "fused_gn_iteration", fn,
        p(cx), p(cy), p(cz), p(cl), p(offx), p(offy), p(offz), p(q0), p(origin),
        p(row_abs), p(used), p(tile_map), TILE_ROWS, ctypes.cast(t12, _V), R, M, P,
        float(sem_th), float(scale), float(voxel_size), float(max_corr), float(kernel_th),
        p(partials), p(counter), p(out), cuda_lib.stream_ptr(dev),
    )
    return out


def gn_terms(cx, cy, cz, cl, offx, offy, offz, q0, origin, row_abs, used, T,
             sem_th, scale, voxel_size, max_corr, kernel_th, tile_map):
    """Plain version of the GN kernel before its reduction: the (18, R*P)
    per-slot terms whose row sums are the kernel's output. A dead tile
    reads tile_map's block as the reference does; its used flags are its
    own (all zero), so it adds zeros: a row without a used slot is left
    at zero and not evaluated (the sums keep their order)."""
    R = cx.shape[0]
    P = used.shape[1]
    dev = cx.device
    rows = torch.nonzero((used != 0).any(dim=1))[:, 0]
    src = (tile_map.long()[rows // TILE_ROWS] * TILE_ROWS + rows % TILE_ROWS).clamp(max=R - 1)
    cxf, cyf, czf, clf, invalid = _dequant(cx[src], cy[src], cz[src], cl[src], offx, offy, offz, scale)
    q = q0[src].reshape(len(rows), P, 4)
    org = origin[src]
    rab = row_abs[src]
    T = T.to(device=dev, dtype=torch.float32)
    x0, y0, z0, ql = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sx = T[0, 0] * x0 + T[0, 1] * y0 + T[0, 2] * z0 + T[0, 3]
    sy = T[1, 0] * x0 + T[1, 1] * y0 + T[1, 2] * z0 + T[1, 3]
    sz = T[2, 0] * x0 + T[2, 1] * y0 + T[2, 2] * z0 + T[2, 3]
    use = used[rows] != 0
    for s, a in ((sx, 0), (sy, 1), (sz, 2)):
        use = use & (torch.abs(trunc_div(s, voxel_size) - rab[:, a : a + 1]) <= 1)
    qx, qy, qz = sx - org[:, 0:1], sy - org[:, 1:2], sz - org[:, 2:3]
    best, _ = _select(cxf, cyf, czf, clf, invalid, qx, qy, qz, ql, sem_th)
    rx = qx - torch.gather(cxf, 1, best)
    ry = qy - torch.gather(cyf, 1, best)
    rz = qz - torch.gather(czf, 1, best)
    r2 = rx * rx + ry * ry + rz * rz
    mc = torch.tensor(max_corr, dtype=torch.float32, device=dev)
    accept = use & ~torch.gather(invalid, 1, best) & (r2 < mc * mc)
    k = torch.tensor(kernel_th, dtype=torch.float32, device=dev)
    w = torch.where(accept, (k * k) / ((k + r2) * (k + r2)), 0.0)
    terms = [
        w, w * sx, w * sy, w * sz,
        w * sx * sx, w * sy * sy, w * sz * sz, w * sx * sy, w * sx * sz, w * sy * sz,
        w * rx, w * ry, w * rz,
        w * (sy * rz - sz * ry), w * (sz * rx - sx * rz), w * (sx * ry - sy * rx),
        accept.to(torch.float32), use.to(torch.float32),
    ]
    out = torch.zeros((N_SUMS, R, P), dtype=torch.float32, device=dev)
    out[:, rows] = torch.stack(terms)
    return out.reshape(N_SUMS, R * P)


def assemble_normal_equations(sums: torch.Tensor):
    """(18,) sums -> (JTJ (6, 6), JTr (6,), ncorr, nused) for the
    Jacobian J = [I | -hat(s)] of a point-to-point residual r = s - t."""
    w = sums[0]
    wsx, wsy, wsz = sums[1], sums[2], sums[3]
    sxx, syy, szz = sums[4], sums[5], sums[6]
    sxy, sxz, syz = sums[7], sums[8], sums[9]
    z = torch.zeros_like(w)
    ur = torch.stack([
        torch.stack([z, wsz, -wsy]),
        torch.stack([-wsz, z, wsx]),
        torch.stack([wsy, -wsx, z]),
    ])
    tr = sxx + syy + szz
    lr = torch.stack([
        torch.stack([tr - sxx, -sxy, -sxz]),
        torch.stack([-sxy, tr - syy, -syz]),
        torch.stack([-sxz, -syz, tr - szz]),
    ])
    ul = w * torch.eye(3, dtype=sums.dtype, device=sums.device)
    JTJ = torch.cat([torch.cat([ul, ur], dim=1), torch.cat([ur.T, lr], dim=1)], dim=0)
    JTr = torch.cat([sums[10:13], sums[13:16]])
    return JTJ, JTr, sums[16].to(torch.int32), sums[17].to(torch.int32)


def radius_count(cx, cy, cz, queries, used, r2):
    """cx/cy/cz (R, M) f32 candidate coordinates (a lane at >= 1e9 never
    counts); queries (R, 3P) f32 packed [x y z]; used (R, P) int32 slot
    flags. Returns (R, P) f32: per slot, the number of candidates of its
    row with (dx*dx + dy*dy) + dz*dz <= r2, times used. Counts are
    integers, so the kernel and the plain version agree bit for bit."""
    if cuda_lib.on_cpu(cx):
        return radius_count_plain(cx, cy, cz, queries, used, r2)
    R, M = cx.shape
    P = used.shape[1]
    for name, t in (("cx", cx), ("cy", cy), ("cz", cz)):
        cuda_lib.check_cuda(name, t, torch.float32, (R, M))
    cuda_lib.check_cuda("queries", queries, torch.float32, (R, 3 * P))
    cuda_lib.check_cuda("used", used, torch.int32, (R, P))
    if radius_count_smem(M, P) > RC_MAX_SMEM:
        raise ValueError(f"radius_count: rows of {M} lanes and {P} slots need "
                         f"{radius_count_smem(M, P)} B of shared memory; a block has {RC_MAX_SMEM}")
    out = torch.empty((R, P), dtype=torch.float32, device=cx.device)
    fn = cuda_lib.function("radius_count.cu", "sage_radius_count", _RC_ARGTYPES)
    p = cuda_lib.ptr
    cuda_lib.call(
        "radius_count", fn,
        p(cx), p(cy), p(cz), p(queries), p(used), R, M, P, float(r2),
        float(skip_margin(r2)), p(out), cuda_lib.stream_ptr(cx.device),
    )
    return out


def radius_count_smem(M: int, P: int) -> int:
    """Bytes of shared memory the radius-count kernel takes for a row of M
    lanes and P slots: a float4 per lane and per query, three ints per
    slot (csrc/radius_count.cu)."""
    return (M + P) * 16 + 3 * P * 4


def skip_margin(r2) -> np.float32:
    """The radius-count kernel's lane-skip margin m for float32 r2: a lane
    farther than m from every used query on one axis is skipped, which is
    exact when fl(m * m) > r2 in float32 (csrc/radius_count.cu proves it).
    The smallest such m up to a 2^-10 slack; +inf (skip nothing) for an
    infinite or NaN r2."""
    r2 = np.float32(r2)
    if not np.isfinite(r2):
        return np.float32(np.inf)
    m = np.float32(math.sqrt(max(float(r2), 0.0)) * (1.0 + 2.0**-10) + 2.0**-60)
    with np.errstate(over="ignore"):
        return m if np.float32(m * m) > r2 else np.float32(np.inf)


def radius_count_plain(cx, cy, cz, queries, used, r2):
    """One (R, M) compare per slot, as the TPU kernel body loops: a
    broadcast to (R, P, M) would hold ~680 MB per temporary at the kitti
    filter's shapes."""
    P = used.shape[1]
    r2 = torch.tensor(r2, dtype=torch.float32, device=cx.device)
    outs = []
    for p in range(P):
        dx = cx - queries[:, 3 * p : 3 * p + 1]
        dy = cy - queries[:, 3 * p + 1 : 3 * p + 2]
        dz = cz - queries[:, 3 * p + 2 : 3 * p + 3]
        d2 = dx * dx + dy * dy + dz * dz
        cnt = (d2 <= r2).sum(dim=1, dtype=torch.int32).to(torch.float32)
        outs.append(cnt * used[:, p].to(torch.float32))
    return torch.stack(outs, dim=1)
