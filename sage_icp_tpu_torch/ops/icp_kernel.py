"""The ICP loop's step on the device: the CUDA kernel csrc/icp_step.cu and
its plain PyTorch version.

After each fused GN iteration (nn_kernels.fused_gn_iteration), one step
turns the 18 sums into the next pose: the normal equations, the damped
6x6 Cholesky solve (a non-finite solution becomes 0, |x| is clamped to
10: a legitimate step is far smaller, and float32 se3_exp of a huge twist
is not orthonormal), T_icp <- exp(x) T_icp, and the loop's tests. It has
no TPU kernel to replace: in the JAX package this is plain jnp inside
register_frame's lax.while_loop (sage_icp_tpu/ops/registration.py:270-289).

Its reference mode (icp_ref_step) is the body of the reference-shaped loop
(registration.RefLoop; JAX :315-333) after the search and the normal
equations: the same solve from JTJ and JTr, the pose update, the count and
the exit test (|x| < 1e-4 or max_iterations), no drift and no re-anchor.
It writes exp(x) to the state's `est`, and the identity once the loop has
stopped, so the source update source <- est . source that follows it is an
ordinary device op that leaves a stopped loop's source as it is.

The loop's state is two small device tensors, updated in place:

    loop_f  float32 (LOOP_F,)  anchor (4x4) | T_icp (4x4) | max_corr |
                               kernel | |x| of the last step | drift |
                               r_scan | 3 unused | est (4x4, the
                               reference mode's)
    loop_i  int32 (LOOP_I,)    iterations | correspondences | status |
                               live rows of the current rows | live
                               rows summed over the running steps

status RUNNING lets the next GN iteration and step run; DONE (converged:
|x| < 1e-4, or max_iterations reached) and REANCHOR (the increment has
drifted past the mover shell: the rows must be rebuilt at the current
pose first) make both a no-op, so a block of iterations can be queued
without reading anything back. The tests run in the JAX loop's order: the
exit first, then the drift.

The plain version writes the kernel's arithmetic out in the same order
(each sum left to right from 0, products expanded, sin, cos and acos in
float64 and rounded, NaN through the maximum and the clamp), one IEEE
operation at a time, so the two agree bit for bit; it reads nothing back
to the host.
"""

from __future__ import annotations

import ctypes

import torch

from sage_icp_tpu_torch.ops import cuda_lib
from sage_icp_tpu_torch.ops.constants import device_constant

LOOP_F = 56
LOOP_I = 5
F_ANCHOR = slice(0, 16)
F_T = slice(16, 32)
F_EST = slice(40, 56)
F_MAX_CORR, F_KERNEL, F_NORM, F_DRIFT, F_R_SCAN = 32, 33, 34, 35, 36
I_ITERATIONS, I_NCORR, I_STATUS, I_ROWS, I_LIVE_ROWS = 0, 1, 2, 3, 4
RUNNING, DONE, REANCHOR = 0, 1, 2
ESTIMATION_THRESHOLD = 1e-4  # the reference loop stops below this |x|

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 2
_REF_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2


def icp_step(sums, loop_f, loop_i, max_iterations: int, drift_lim: float) -> None:
    """One step of the ICP loop from the (18,) GN sums, in place on
    loop_f / loop_i; a no-op unless the status is RUNNING."""
    if cuda_lib.on_cpu(sums):
        return icp_step_plain(sums, loop_f, loop_i, max_iterations, drift_lim)
    cuda_lib.check_cuda("sums", sums, torch.float32, (18,))
    cuda_lib.check_cuda("loop_f", loop_f, torch.float32, (LOOP_F,))
    cuda_lib.check_cuda("loop_i", loop_i, torch.int32, (LOOP_I,))
    fn = cuda_lib.function("icp_step.cu", "sage_icp_step", _ARGTYPES)
    p = cuda_lib.ptr
    cuda_lib.call("icp_step", fn, sums.device, p(sums), p(loop_f), p(loop_i), int(max_iterations),
                  float(drift_lim))


def icp_ref_step(JTJ, JTr, ncorr, loop_f, loop_i, max_iterations: int) -> None:
    """One step of the reference-shaped loop from its (6, 6) JTJ, (6,) JTr
    and 0-dim int32 correspondence count, in place on loop_f / loop_i;
    with a status other than RUNNING it only sets est to the identity."""
    if cuda_lib.on_cpu(JTJ):
        return icp_ref_step_plain(JTJ, JTr, ncorr, loop_f, loop_i, max_iterations)
    cuda_lib.check_cuda("JTJ", JTJ, torch.float32, (6, 6))
    cuda_lib.check_cuda("JTr", JTr, torch.float32, (6,))
    cuda_lib.check_cuda("ncorr", ncorr, torch.int32, ())
    cuda_lib.check_cuda("loop_f", loop_f, torch.float32, (LOOP_F,))
    cuda_lib.check_cuda("loop_i", loop_i, torch.int32, (LOOP_I,))
    fn = cuda_lib.function("icp_step.cu", "sage_icp_ref_step", _REF_ARGTYPES)
    p = cuda_lib.ptr
    cuda_lib.call("icp_ref_step", fn, JTJ.device, p(JTJ), p(JTr), p(ncorr), p(loop_f), p(loop_i),
                  int(max_iterations))


def _sum(terms, like):
    """Left to right from 0, as the kernel adds."""
    acc = torch.zeros_like(like)
    for t in terms:
        acc = acc + t
    return acc


def _c(v: float, dev) -> torch.Tensor:
    """A float32 divisor on the device: CUDA divides by a Python scalar
    as a multiply by its reciprocal, which is not the kernel's division."""
    return device_constant(v, torch.float32, dev)


def _f64(fn, x: torch.Tensor) -> torch.Tensor:
    return fn(x.to(torch.float64)).to(torch.float32)


def solve_increment(sums: torch.Tensor):
    """(18,) sums -> (x (6,) after the finite guard and the clamp, |x|,
    correspondences): the kernel's solve. 0-dim tensors throughout."""
    from sage_icp_tpu_torch.ops.nn_kernels import assemble_normal_equations

    JTJ, JTr, ncorr, _ = assemble_normal_equations(sums)
    return (*solve_system(JTJ, JTr), ncorr)


def solve_system(JTJ: torch.Tensor, JTr: torch.Tensor):
    """(JTJ + 1e-8 I) x = -JTr by the kernel's Cholesky -> (x (6,) after
    the finite guard and the clamp, |x|)."""
    dev = JTJ.device
    A = [[JTJ[i, j] + (1e-8 if i == j else 0.0) for j in range(6)] for i in range(6)]
    b = [-JTr[i] for i in range(6)]
    tiny = _c(1e-30, dev)
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            v = A[i][j] - _sum([L[i][k] * L[j][k] for k in range(j)], tiny)
            if i == j:
                L[i][i] = torch.sqrt(torch.where(tiny > v, tiny, v))  # NaN stays NaN
            else:
                L[i][j] = v / L[j][j]
    y = []
    for i in range(6):
        y.append((b[i] - _sum([L[i][k] * y[k] for k in range(i)], tiny)) / L[i][i])
    x = [None] * 6
    for i in reversed(range(6)):
        x[i] = (y[i] - _sum([L[k][i] * x[k] for k in range(i + 1, 6)], tiny)) / L[i][i]
    x = torch.stack(x)
    x = torch.where(torch.isfinite(x).all(), x, torch.zeros_like(x))
    n = torch.sqrt(_sum([x[i] * x[i] for i in range(6)], tiny))
    x = torch.where(n > 10.0, x * (_c(10.0, dev) / torch.where(n > tiny, n, tiny)), x)
    norm = torch.sqrt(_sum([x[i] * x[i] for i in range(6)], tiny))
    return x, norm


def se3_exp(x: torch.Tensor) -> torch.Tensor:
    """(6,) [rho, phi] -> (4, 4), geometry.se3_exp's formula with the
    kernel's order of operations."""
    dev = x.device
    p0, p1, p2 = x[3], x[4], x[5]
    theta2 = _sum([p0 * p0, p1 * p1, p2 * p2], p0)
    theta = torch.sqrt(theta2 + 1e-8 * 1e-8)
    small = theta < 1e-4
    sin_t, cos_t = _f64(torch.sin, theta), _f64(torch.cos, theta)
    ca = torch.where(small, 1.0 - theta2 / _c(6.0, dev), sin_t / theta)
    cb = torch.where(small, 0.5 - theta2 / _c(24.0, dev), (1.0 - cos_t) / theta2)
    cc = torch.where(small, 1.0 / 6.0 - theta2 / _c(120.0, dev), (theta - sin_t) / (theta2 * theta))
    z = torch.zeros_like(p0)
    K = torch.stack([torch.stack([z, -p2, p1]), torch.stack([p2, z, -p0]), torch.stack([-p1, p0, z])])
    KK = (K[:, 0:1] * K[0:1, :] + K[:, 1:2] * K[1:2, :]) + K[:, 2:3] * K[2:3, :]
    eye = torch.eye(3, dtype=x.dtype, device=dev)
    R = (eye + ca * K) + cb * KK
    V = (eye + cb * K) + cc * KK
    t = (V[:, 0] * x[0] + V[:, 1] * x[1]) + V[:, 2] * x[2]
    top = torch.cat([R, t[:, None]], dim=1)
    bottom = torch.eye(4, dtype=x.dtype, device=dev)[3:]
    return torch.cat([top, bottom])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for 4x4 poses, each entry's four products added left to
    right (the kernel's order; the same bits on every device)."""
    return ((A[:, 0:1] * B[0:1, :] + A[:, 1:2] * B[1:2, :]) + A[:, 2:3] * B[2:3, :]) + A[:, 3:4] * B[3:4, :]


def anchor_drift(T: torch.Tensor, anchor_pos: torch.Tensor, r_scan: torch.Tensor) -> torch.Tensor:
    """Displacement of the anchor position under the increment T plus the
    rotation arc at the scan radius."""
    moved = ((T[:3, 0] * anchor_pos[0] + T[:3, 1] * anchor_pos[1]) + T[:3, 2] * anchor_pos[2] + T[:3, 3]) - anchor_pos
    dist = torch.sqrt(_sum([moved[i] * moved[i] for i in range(3)], r_scan))
    ct = ((T[0, 0] + T[1, 1]) + T[2, 2] - 1.0) * 0.5
    ct = torch.clamp(ct, -1.0, 1.0)  # NaN stays NaN
    return dist + _f64(torch.acos, ct) * r_scan


def icp_step_plain(sums, loop_f, loop_i, max_iterations: int, drift_lim: float) -> None:
    running = loop_i[I_STATUS] == RUNNING
    x, norm, ncorr = solve_increment(sums)
    T = loop_f[F_T].reshape(4, 4)
    Tn = compose(se3_exp(x), T)
    drift = anchor_drift(Tn, loop_f[F_ANCHOR].reshape(4, 4)[:3, 3], loop_f[F_R_SCAN])
    it = loop_i[I_ITERATIONS] + 1
    more = (it < max_iterations) & (norm >= ESTIMATION_THRESHOLD)
    status = torch.where(~more, DONE, torch.where(drift >= drift_lim, REANCHOR, RUNNING)).to(torch.int32)
    new_f = torch.cat([loop_f[F_ANCHOR], Tn.reshape(-1), loop_f[F_MAX_CORR:F_NORM], norm[None], drift[None],
                       loop_f[F_DRIFT + 1:]])
    new_i = torch.stack([it, ncorr, status, loop_i[I_ROWS], loop_i[I_LIVE_ROWS] + loop_i[I_ROWS]]).to(torch.int32)
    loop_f.copy_(torch.where(running, new_f, loop_f))
    loop_i.copy_(torch.where(running, new_i, loop_i))


def icp_ref_step_plain(JTJ, JTr, ncorr, loop_f, loop_i, max_iterations: int) -> None:
    running = loop_i[I_STATUS] == RUNNING
    x, norm = solve_system(JTJ, JTr)
    est = se3_exp(x)
    Tn = compose(est, loop_f[F_T].reshape(4, 4))
    it = loop_i[I_ITERATIONS] + 1
    more = (it < max_iterations) & (norm >= ESTIMATION_THRESHOLD)
    status = torch.where(more, RUNNING, DONE).to(torch.int32)
    new_f = torch.cat([loop_f[F_ANCHOR], Tn.reshape(-1), loop_f[F_MAX_CORR:F_NORM], norm[None],
                       loop_f[F_NORM + 1:F_EST.start], est.reshape(-1)])
    eye = torch.eye(4, dtype=loop_f.dtype, device=loop_f.device).reshape(-1)
    stopped = torch.cat([loop_f[:F_EST.start], eye])
    new_i = torch.stack([it, ncorr.to(torch.int32), status, loop_i[I_ROWS], loop_i[I_LIVE_ROWS]]).to(torch.int32)
    loop_f.copy_(torch.where(running, new_f, stopped))
    loop_i.copy_(torch.where(running, new_i, loop_i))
