"""SO(3)/SE(3) Lie-group ops in PyTorch.

Same conventions as Sophus and as the JAX reference package: a pose is a
4x4 homogeneous matrix, a twist is [rho(3), phi(3)] with the translation
part first. Every function takes batched tensors (leading dims) on any
device and keeps their dtype (float32 on the odometry path).

Pose products run in full float32: `pin_full_fp32` turns TF32 off for
cuBLAS and cuDNN (the reference pins precision="highest" on the same
matmuls), and the entry points call it. sin, cos and atan2 are evaluated
in float64 and rounded, so a float32 result is the correctly rounded one
on the CPU and on the card alike: the coefficient (1 - cos t) / t^2 of
small rotations turns one ulp of cos into a visible error (up to 1e-5 m
in a deskewed point), and PyTorch's float32 cos on the CPU is not
correctly rounded near 0.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def pin_full_fp32() -> None:
    """Keep float32 matmuls and convolutions out of TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.to(torch.float64)).to(x.dtype)


def _cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.to(torch.float64)).to(x.dtype)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrix."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def _so3_terms(phi: torch.Tensor):
    """The parts of exp(phi) that so3_exp and se3_exp share: theta^2,
    theta, the series-branch mask, sin(theta), b = (1 - cos t) / t^2,
    K = hat(phi) and K @ K."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta < 1e-4
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - _cos(theta)) / theta2)
    K = hat(phi)
    return theta2, theta, small, _sin(theta), b, K, K @ K


def _rodrigues(phi, theta2, theta, small, sin_t, b, K, KK) -> torch.Tensor:
    a = torch.where(small, 1.0 - theta2 / 6.0, sin_t / theta)
    return _eye3(phi) + a[..., None, None] * K + b[..., None, None] * KK


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with a series branch near zero."""
    return _rodrigues(phi, *_so3_terms(phi))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z) with w >= 0
    (Shepperd's method, branch-free)."""
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
    """Inverse of so3_exp through the quaternion (stable near pi)."""
    q = rotmat_to_quat(R)
    w = q[..., 0]
    xyz = q[..., 1:]
    n = torch.linalg.vector_norm(xyz, dim=-1)
    angle = 2.0 * torch.atan2(n.to(torch.float64), w.to(torch.float64)).to(n.dtype)
    scale = torch.where(
        n < 1e-7,
        2.0 / torch.clamp(w, min=_EPS),
        angle / torch.clamp(n, min=_EPS),
    )
    return xyz * scale[..., None]


def _rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)  # a scalar assigned to one element would be uploaded from the host
    return T


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: [rho, phi] -> 4x4."""
    rho, phi = xi[..., :3], xi[..., 3:]
    terms = _so3_terms(phi)
    theta2, theta, small, sin_t, b, K, KK = terms
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - sin_t) / (theta2 * theta))
    V = _eye3(xi) + b[..., None, None] * K + c[..., None, None] * KK
    t = (V @ rho[..., None])[..., 0]
    return _rt_to_mat(_rodrigues(phi, *terms), t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Inverse of se3_exp: 4x4 -> [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta < 1e-4
    K = hat(phi)
    half = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * _cos(half) / torch.clamp(_sin(half), min=_EPS)) / theta2,
    )
    Vinv = _eye3(T) - 0.5 * K + cot_term[..., None, None] * (K @ K)
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _rt_to_mat(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def se3_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def renormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) with one Newton-Schulz
    polar step, R <- R (3I - R^T R) / 2. Runs on every carried pose: a
    raw 4x4 float32 pose has no orthonormality invariant, and the
    constant-velocity prediction last @ inv(prev) @ last compounds any
    scale error frame over frame."""
    R = T[..., :3, :3]
    RtR = R.transpose(-1, -2) @ R
    R2 = R @ (1.5 * _eye3(T) - 0.5 * RtR)
    return _rt_to_mat(R2, T[..., :3, 3])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 pose to (N, 4) xyz+label rows; the label lane rides
    along unchanged."""
    xyz = pts[..., :3] @ T[:3, :3].T + T[:3, 3]
    return torch.cat([xyz, pts[..., 3:]], dim=-1)


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Angle of a rotation matrix (norm of its log)."""
    return torch.linalg.vector_norm(so3_log(R), dim=-1)


def umeyama_alignment(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = False) -> torch.Tensor:
    """Closed-form alignment dst ~= c R src + t (Eigen::umeyama, used by
    the ATE metric, reference metrics/Metrics.cpp:169). src, dst (N, 3);
    returns the 4x4 transform in their dtype."""
    mu_s, mu_d = src.mean(dim=0), dst.mean(dim=0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, D, Vt = torch.linalg.svd(cov)
    S = torch.eye(3, dtype=src.dtype, device=src.device)
    if torch.linalg.det(U) * torch.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    c = torch.trace(torch.diag(D) @ S) / torch.mean(torch.sum(sc * sc, dim=-1)) if with_scale else 1.0
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    T[:3, :3] = c * R
    T[:3, 3] = mu_d - c * (R @ mu_s)
    return T
