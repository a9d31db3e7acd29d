"""The ICP solve of the reference step: point-to-point Gauss-Newton with a
Geman-McClure weight, as in the upstream registration core.

  * residual r = s - t, Jacobian J = [I | -hat(s)]
  * weight w = kernel^2 / (kernel + |r|^2)^2
  * (J^T W J + 1e-8 I) x = -(J^T W r) by an unrolled Cholesky; a
    non-finite x becomes 0 and |x| is clamped to 10
  * T <- exp(x) T; stop when |x| < 1e-4 or after max_iterations

frozen_rows_loop is the fast path: correspondence rows built at an anchor
pose (correspondence.corr_setup), each iteration one semantic NN pass
over them, the rows rebuilt at the current pose once the increment has
moved the anchor by 0.45 voxel (position plus the rotation arc at the
scan radius). reference_loop searches the map afresh every iteration.
The device computes the candidate selection and the sums; the 6x6 solve
and the loop's tests run on the host, one operation at a time in the
order written here, and the host decides after every iteration whether
the loop goes on."""

from __future__ import annotations

import numpy as np
import torch

from . import correspondence as corr
from . import voxel_map as vm
from .geometry import transform_points
from .scan import const, trunc_div

ESTIMATION_THRESHOLD = 1e-4
BIG_D2 = 1.0e12
RUNNING, DONE, REANCHOR = 0, 1, 2


def _dequant(planes, offs, scale):
    cx, cy, cz, cl = planes
    cxf = cx.to(torch.float32).mul_(scale).add_(offs[0])
    cyf = cy.to(torch.float32).mul_(scale).add_(offs[1])
    czf = cz.to(torch.float32).mul_(scale).add_(offs[2])
    clf = cl.to(torch.float32)
    return cxf, cyf, czf, clf, clf < 0.0


def _select(cxf, cyf, czf, clf, invalid, qx, qy, qz, ql, sem_th):
    """First minimum of the sem_th-scaled squared distance per query slot
    (labels equal, or either 0); returns (winner lanes, unweighted d2)."""
    d2 = cxf[:, None, :] - qx[..., None]
    d2.mul_(d2)
    t = cyf[:, None, :] - qy[..., None]
    d2.add_(t.mul_(t))
    t = torch.sub(czf[:, None, :], qz[..., None], out=t)
    d2.add_(t.mul_(t))
    sem = ((clf[:, None, :] == ql[..., None]) | ((clf == 0.0)[:, None, :] & torch.isfinite(ql)[..., None])
           | (ql == 0.0)[..., None])
    d2w = torch.where(sem, d2 * sem_th, d2)
    d2w.masked_fill_(invalid[:, None, :], torch.finfo(torch.float32).max)
    return torch.argmin(d2w, dim=-1), d2


def gn_sums(rows: corr.Rows, offs, T, sem_th, scale, voxel_size, max_corr, kernel) -> torch.Tensor:
    """The 18 sums of one GN iteration over the rows with a used slot:
    w, w s (3), w s_i s_j (6), w r (3), w (s x r) (3), accepted, used."""
    R, P = rows.used.shape
    dev = rows.q0.device
    live = torch.nonzero(rows.used.any(dim=1))[:, 0]
    cxf, cyf, czf, clf, invalid = _dequant([p[live] for p in rows.planes], offs, scale)
    q = rows.q0[live]
    org, rab = rows.origin[live], rows.row_abs[live]
    x0, y0, z0, ql = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sx = T[0, 0] * x0 + T[0, 1] * y0 + T[0, 2] * z0 + T[0, 3]
    sy = T[1, 0] * x0 + T[1, 1] * y0 + T[1, 2] * z0 + T[1, 3]
    sz = T[2, 0] * x0 + T[2, 1] * y0 + T[2, 2] * z0 + T[2, 3]
    use = rows.used[live]
    for s, a in ((sx, 0), (sy, 1), (sz, 2)):
        use = use & (torch.abs(trunc_div(s, voxel_size) - rab[:, a : a + 1]) <= 1)
    qx, qy, qz = sx - org[:, 0:1], sy - org[:, 1:2], sz - org[:, 2:3]
    best, _ = _select(cxf, cyf, czf, clf, invalid, qx, qy, qz, ql, sem_th)
    rx = qx - torch.gather(cxf, 1, best)
    ry = qy - torch.gather(cyf, 1, best)
    rz = qz - torch.gather(czf, 1, best)
    r2 = rx * rx + ry * ry + rz * rz
    accept = use & ~torch.gather(invalid, 1, best) & (r2 < max_corr * max_corr)
    w = torch.where(accept, (kernel * kernel) / ((kernel + r2) * (kernel + r2)), 0.0)
    terms = [
        w, w * sx, w * sy, w * sz,
        w * sx * sx, w * sy * sy, w * sz * sz, w * sx * sy, w * sx * sz, w * sy * sz,
        w * rx, w * ry, w * rz,
        w * (sy * rz - sz * ry), w * (sz * rx - sx * rz), w * (sx * ry - sy * rx),
        accept.to(torch.float32), use.to(torch.float32),
    ]
    out = torch.zeros((18, R, P), dtype=torch.float32, device=dev)
    out[:, live] = torch.stack(terms)
    return out.reshape(18, R * P).sum(dim=1)


def _sum(terms, like):
    acc = torch.zeros_like(like)
    for t in terms:
        acc = acc + t
    return acc


def _f64(fn, x):
    return fn(x.to(torch.float64)).to(torch.float32)


def normal_equations(sums):
    """(18,) sums -> (J^T W J (6, 6), J^T W r (6,), accepted count)."""
    w = sums[0]
    wsx, wsy, wsz = sums[1], sums[2], sums[3]
    sxx, syy, szz, sxy, sxz, syz = (sums[i] for i in range(4, 10))
    z = torch.zeros_like(w)
    ur = torch.stack([torch.stack([z, wsz, -wsy]), torch.stack([-wsz, z, wsx]), torch.stack([wsy, -wsx, z])])
    tr = sxx + syy + szz
    lr = torch.stack([torch.stack([tr - sxx, -sxy, -sxz]), torch.stack([-sxy, tr - syy, -syz]),
                      torch.stack([-sxz, -syz, tr - szz])])
    ul = w * torch.eye(3, dtype=sums.dtype, device=sums.device)
    JTJ = torch.cat([torch.cat([ul, ur], dim=1), torch.cat([ur.T, lr], dim=1)], dim=0)
    return JTJ, torch.cat([sums[10:13], sums[13:16]]), sums[16].to(torch.int32)


def solve_system(JTJ, JTr):
    """(x after the finite guard and the clamp, |x|)."""
    dev = JTJ.device
    A = [[JTJ[i, j] + (1e-8 if i == j else 0.0) for j in range(6)] for i in range(6)]
    b = [-JTr[i] for i in range(6)]
    tiny = const(1e-30, torch.float32, dev)
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            v = A[i][j] - _sum([L[i][k] * L[j][k] for k in range(j)], tiny)
            L[i][j] = torch.sqrt(torch.where(tiny > v, tiny, v)) if i == j else v / L[j][j]
    y = []
    for i in range(6):
        y.append((b[i] - _sum([L[i][k] * y[k] for k in range(i)], tiny)) / L[i][i])
    x = [None] * 6
    for i in reversed(range(6)):
        x[i] = (y[i] - _sum([L[k][i] * x[k] for k in range(i + 1, 6)], tiny)) / L[i][i]
    x = torch.stack(x)
    x = torch.where(torch.isfinite(x).all(), x, torch.zeros_like(x))
    n = torch.sqrt(_sum([x[i] * x[i] for i in range(6)], tiny))
    x = torch.where(n > 10.0, x * (const(10.0, torch.float32, dev) / torch.where(n > tiny, n, tiny)), x)
    return x, torch.sqrt(_sum([x[i] * x[i] for i in range(6)], tiny))


def se3_exp(x):
    """(6,) [rho, phi] -> (4, 4)."""
    dev = x.device
    p0, p1, p2 = x[3], x[4], x[5]
    theta2 = _sum([p0 * p0, p1 * p1, p2 * p2], p0)
    theta = torch.sqrt(theta2 + 1e-8 * 1e-8)
    small = theta < 1e-4
    sin_t, cos_t = _f64(torch.sin, theta), _f64(torch.cos, theta)
    c = lambda v: const(v, torch.float32, dev)  # noqa: E731
    ca = torch.where(small, 1.0 - theta2 / c(6.0), sin_t / theta)
    cb = torch.where(small, 0.5 - theta2 / c(24.0), (1.0 - cos_t) / theta2)
    cc = torch.where(small, 1.0 / 6.0 - theta2 / c(120.0), (theta - sin_t) / (theta2 * theta))
    z = torch.zeros_like(p0)
    K = torch.stack([torch.stack([z, -p2, p1]), torch.stack([p2, z, -p0]), torch.stack([-p1, p0, z])])
    KK = (K[:, 0:1] * K[0:1, :] + K[:, 1:2] * K[1:2, :]) + K[:, 2:3] * K[2:3, :]
    eye = torch.eye(3, dtype=x.dtype, device=dev)
    R = (eye + ca * K) + cb * KK
    V = (eye + cb * K) + cc * KK
    t = (V[:, 0] * x[0] + V[:, 1] * x[1]) + V[:, 2] * x[2]
    return torch.cat([torch.cat([R, t[:, None]], dim=1), torch.eye(4, dtype=x.dtype, device=dev)[3:]])


def compose(A, B):
    """A @ B for 4x4 poses, each entry's products added left to right."""
    return ((A[:, 0:1] * B[0:1, :] + A[:, 1:2] * B[1:2, :]) + A[:, 2:3] * B[2:3, :]) + A[:, 3:4] * B[3:4, :]


def anchor_drift(T, anchor_pos, r_scan):
    moved = ((T[:3, 0] * anchor_pos[0] + T[:3, 1] * anchor_pos[1]) + T[:3, 2] * anchor_pos[2] + T[:3, 3]) - anchor_pos
    dist = torch.sqrt(_sum([moved[i] * moved[i] for i in range(3)], r_scan))
    ct = torch.clamp(((T[0, 0] + T[1, 1]) + T[2, 2] - 1.0) * 0.5, -1.0, 1.0)
    return dist + _f64(torch.acos, ct) * r_scan


def frozen_rows_loop(map_state, tables, frame, valid, guess, voxel_size, max_corr, kernel, sem_th,
                     max_iterations: int, fast_params: dict):
    """Returns (pose (4, 4), iterations, correspondences at the last
    iteration, dropped queries, [live rows of each iteration run]); the
    pose and counts are device tensors."""
    dev = frame.device
    host = torch.device("cpu")
    offs = corr.lane_offsets(map_state.points_per_voxel, voxel_size, dev)
    scale = voxel_size / vm.QSCALE
    drift_lim = float(np.float32(0.45 * voxel_size))
    r2 = torch.sum(frame[:, :3] * frame[:, :3], dim=-1)
    r_scan = torch.sqrt(torch.max(torch.where(valid, r2, 0.0))).to(host)
    anchor = guess.to(host)
    T = torch.eye(4, dtype=torch.float32)
    iterations = ncorr = 0
    live_rows = []

    def rows_at(pose):
        rows = corr.corr_setup(map_state, tables, transform_points(pose.to(dev), frame), valid, voxel_size,
                               **fast_params)
        return rows, int(rows.used.any(dim=1).sum())

    rows, n_live = rows_at(anchor)
    while True:
        sums = gn_sums(rows, offs, T.to(dev), sem_th, scale, voxel_size, max_corr, kernel).to(host)
        JTJ, JTr, nc = normal_equations(sums)
        x, norm = solve_system(JTJ, JTr)
        T = compose(se3_exp(x), T)
        drift = anchor_drift(T, anchor[:3, 3], r_scan)
        iterations, ncorr = iterations + 1, int(nc)
        live_rows.append(n_live)
        if iterations >= max_iterations or not bool(norm >= ESTIMATION_THRESHOLD):
            break
        if bool(drift >= drift_lim):
            anchor, T = compose(T, anchor), torch.eye(4, dtype=torch.float32)
            rows, n_live = rows_at(anchor)
    pose = compose(T, anchor).to(dev)
    return pose, iterations, ncorr, rows.n_dropped, live_rows


def build_normal_equations(src, tgt, weight_mask, kernel):
    s = src[:, :3]
    r = s - tgt[:, :3]
    r2 = torch.sum(r * r, dim=-1)
    w = torch.where(weight_mask, (kernel * kernel) / torch.square(kernel + r2), 0.0)
    n = s.shape[0]
    zeros = torch.zeros((n,), dtype=s.dtype, device=s.device)
    ones = torch.ones_like(zeros)
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    J = torch.stack([
        torch.stack([ones, zeros, zeros, zeros, sz, -sy], dim=-1),
        torch.stack([zeros, ones, zeros, -sz, zeros, sx], dim=-1),
        torch.stack([zeros, zeros, ones, sy, -sx, zeros], dim=-1),
    ], dim=1)
    Jwf = (J * w[:, None, None]).reshape(n * 3, 6)
    return Jwf.T @ J.reshape(n * 3, 6), Jwf.T @ r.reshape(n * 3)


def reference_loop(map_state, frame, valid, guess, voxel_size, max_corr, kernel, sem_th, max_iterations: int,
                   probe_depth: int):
    """The loop without frozen rows: every iteration searches the 27
    neighbouring voxels of every source. Returns frozen_rows_loop's
    values (no row is ever dropped, and no rows are counted)."""
    dev = frame.device
    host = torch.device("cpu")
    source = transform_points(guess, frame)
    T = torch.eye(4, dtype=torch.float32)
    iterations = ncorr = 0
    while True:
        tgt, accept = vm.get_correspondences(map_state, source, valid, voxel_size, max_corr, sem_th, probe_depth)
        JTJ, JTr = build_normal_equations(source, tgt, accept, kernel)
        x, norm = solve_system(JTJ.to(host), JTr.to(host))
        est = se3_exp(x)
        T = compose(est, T)
        iterations, ncorr = iterations + 1, int(accept.sum(dtype=torch.int32))
        if iterations >= max_iterations or not bool(norm >= ESTIMATION_THRESHOLD):
            break
        source = transform_points(est.to(dev), source)
    pose = compose(T, guess.to(host)).to(dev)
    return pose, iterations, ncorr, torch.zeros((), dtype=torch.int32, device=dev), []
