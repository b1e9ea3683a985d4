"""SO(3)/SE(3) and quaternion math in torch.

Same conventions as `sags_tpu.core.transforms`: quaternions are stored
**xyzw** (the reference rasterizer's `forward.cu:134-145` order), `so3_exp`
follows `fast_gicp/so3/so3.hpp`, and every function broadcasts over leading
axes.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) [..., 4] (xyzw)."""
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (xyzw, assumed normalized) -> rotation matrix [..., 3, 3]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack([
        torch.stack([r00, r01, r02], -1),
        torch.stack([r10, r11, r12], -1),
        torch.stack([r20, r21, r22], -1),
    ], -2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (xyzw), branch-free
    4-branch Shepperd selection (`torch.where`), as in the JAX package."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return quat_normalize(q)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both xyzw."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], -1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (hat) matrix [..., 3, 3] of v [..., 3]."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """so(3) -> SO(3) rotation matrix, small-angle safe (`so3.hpp:so3_exp`)."""
    theta_sq = torch.sum(w * w, -1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS))
    small = theta_sq < 1e-8
    imag = torch.where(
        small,
        0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_sq * theta_sq,
        torch.sin(0.5 * theta) / theta,
    )
    real = torch.where(
        small,
        1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_sq * theta_sq,
        torch.cos(0.5 * theta),
    )
    q = torch.cat([imag[..., None] * w, real[..., None]], -1)
    return quat_to_rotmat(quat_normalize(q))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) -> so(3) axis-angle vector [..., 3]."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    factor = torch.where(
        theta < 1e-4,
        0.5 + theta * theta / 12.0,
        theta / torch.clamp(2.0 * torch.sin(theta), min=_EPS),
    )
    return factor[..., None] * w


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Homogeneous [..., 4, 4] from R [..., 3, 3] and t [..., 3]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return se3_matrix(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply SE(3) [4,4] to points [..., 3]."""
    return pts @ T[:3, :3].T + T[:3, 3]


def build_scaling_rotation(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): Σ = L Lᵀ."""
    R = quat_to_rotmat(quat_normalize(quats))
    return R * scales[..., None, :]


def quat_scale_to_cov(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """(scale, quat xyzw) -> full 3x3 covariance Σ = R S² Rᵀ [..., 3, 3]."""
    L = build_scaling_rotation(scales, quats)
    return L @ L.transpose(-1, -2)


# LiDAR body → camera axes (FLU → RDF), the reference's
# `R_cam @ (Rz_90 @ Rx_minus_90)` fix (`scripts/gaussian_splatting.py:309-315`).
LIDAR_TO_CAM = (
    np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], dtype=np.float32)
    @ np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], dtype=np.float32)
)
