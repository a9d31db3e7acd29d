"""Pose arithmetic of the reference step: 4x4 float32 homogeneous
matrices, [rho, phi] twists with the translation first (Sophus's
convention). Matrix products are plain `@`: whether they run in full
float32 or in TF32 is the caller's setting (reference/__init__.py)."""

from __future__ import annotations

import torch

_EPS = 1e-8


def _rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)
    return T


def _rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0 (Shepperd,
    branch-free)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=0.0) + _EPS) * 2.0

    s0 = root(tr + 1.0)
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    q = _rotmat_to_quat(R)
    w, xyz = q[..., 0], q[..., 1:]
    n = torch.linalg.vector_norm(xyz, dim=-1)
    angle = 2.0 * torch.atan2(n.to(torch.float64), w.to(torch.float64)).to(n.dtype)
    scale = torch.where(n < 1e-7, 2.0 / torch.clamp(w, min=_EPS), angle / torch.clamp(n, min=_EPS))
    return xyz * scale[..., None]


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(so3_log(R), dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _rt_to_mat(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def renormalize(T: torch.Tensor) -> torch.Tensor:
    """One Newton-Schulz polar step on the rotation block."""
    R = T[..., :3, :3]
    RtR = R.transpose(-1, -2) @ R
    R2 = R @ (1.5 * torch.eye(3, dtype=T.dtype, device=T.device) - 0.5 * RtR)
    return _rt_to_mat(R2, T[..., :3, 3])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(N, 4) xyz+label rows under a 4x4 pose; the label rides along."""
    xyz = pts[..., :3] @ T[:3, :3].T + T[:3, 3]
    return torch.cat([xyz, pts[..., 3:]], dim=-1)
