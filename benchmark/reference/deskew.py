"""Constant-velocity motion compensation of the reference step, written
from upstream's description (core/Deskew.cpp:36-50, KISS-ICP's
DeSkewScan): a point measured at sweep phase t in [0, 1] moves by
exp((t - 0.5) delta), where delta = log(start^-1 finish) is the twist of
the motion between the two last poses, so that the whole scan stands at
the middle of its sweep. sageICP.cpp:38-50 deskews only once there are
three poses; the step gates it.

Twists are [rho, phi], the translation first (Sophus's convention).
Float32; the per-point poses are applied by a batched matrix product,
in full float32 or in TF32 as the caller sets (odometry.precision)."""

from __future__ import annotations

import math

import torch

from .geometry import se3_inverse, so3_log

# below this angle (rad) the coefficients take their series, which
# float32 evaluates without the cancellation of the closed forms
SERIES_BELOW = 0.1


def _hat(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3), hat(phi) v = phi x v."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(phi.shape[:-1] + (3, 3))


def _exp_coefficients(theta: torch.Tensor):
    """sin(th) / th, (1 - cos(th)) / th^2, (th - sin(th)) / th^3."""
    small = theta < SERIES_BELOW
    th = torch.where(small, torch.ones_like(theta), theta)
    t2 = theta * theta
    a = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - torch.cos(th)) / (th * th))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0, (th - torch.sin(th)) / (th * th * th))
    return a, b, c


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twists -> (..., 4, 4): R = I + a K + b K^2 and the
    translation V rho, V = I + b K + c K^2, K = hat(phi)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    a, b, c = (x[..., None, None] for x in _exp_coefficients(torch.linalg.vector_norm(phi, dim=-1)))
    K = _hat(phi)
    K2 = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = eye + a * K + b * K2
    T[..., :3, 3] = ((eye + b * K + c * K2) @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(4, 4) -> (6,): phi = log(R), rho = V^-1 t with
    V^-1 = I - K / 2 + (1 - th sin(th) / (2 (1 - cos(th)))) / th^2 K^2."""
    phi = so3_log(T[:3, :3])
    theta = torch.linalg.vector_norm(phi)
    th = torch.where(theta < SERIES_BELOW, torch.ones_like(theta), theta)
    t2 = theta * theta
    d = torch.where(theta < SERIES_BELOW, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
                    (1.0 - th * torch.sin(th) / (2.0 * (1.0 - torch.cos(th)))) / (th * th))
    K = _hat(phi)
    v_inv = torch.eye(3, dtype=T.dtype, device=T.device) - 0.5 * K + d * (K @ K)
    return torch.cat([(v_inv @ T[:3, 3:4])[:, 0], phi])


def deskew(points: torch.Tensor, timestamps: torch.Tensor, start_pose: torch.Tensor,
           finish_pose: torch.Tensor) -> torch.Tensor:
    """(N, 4) rows [x y z label], (N,) sweep phases, the two last poses ->
    the rows with each xyz moved by exp((t - 0.5) log(start^-1 finish));
    the label rides along."""
    delta = se3_log(se3_inverse(start_pose) @ finish_pose)
    T = se3_exp((timestamps - 0.5)[:, None] * delta)
    xyz = (T[:, :3, :3] @ points[:, :3, None])[..., 0] + T[:, :3, 3]
    return torch.cat([xyz, points[:, 3:]], dim=-1)


def azimuth_phase(xyz) -> torch.Tensor:
    """The sweep phase a point's azimuth gives where the sensor gives no
    time: the HDL-64E spins clockwise, t = (pi - atan2(y, x)) / (2 pi).
    (n, 3) float32 rows on the host -> (n,) float32."""
    xyz = torch.as_tensor(xyz).to(torch.float64)
    return ((math.pi - torch.atan2(xyz[:, 1], xyz[:, 0])) / (2.0 * math.pi)).to(torch.float32)
