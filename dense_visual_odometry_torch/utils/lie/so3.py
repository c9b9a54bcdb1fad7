"""SO(3) as branchless torch functions over (..., 3, 3) matrices.

Same formulas and the same small-angle series thresholds as
``dense_visual_odometry_tpu/utils/lie/so3.py``: the theta ~ 0 neighbourhood
uses Taylor series and ``log`` goes through a Shepperd quaternion, so it is
stable up to theta ~ pi.  ``(..., 3)`` axis-angle vectors are the Lie-algebra
coordinates.
"""

from __future__ import annotations

import torch

# Below this angle (radians) the closed forms switch to Taylor series: in
# f32, 1 - cos(theta) underflows already at theta ~ 1.5e-4.
_SMALL_ANGLE = 1e-2


def hat(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew matrix with ``hat(a) @ b == cross(a, b)``."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _sin_by_theta(theta_sq, theta):
    small = theta_sq < _SMALL_ANGLE**2
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    series = 1.0 - theta_sq / 6.0 + theta_sq * theta_sq / 120.0
    return torch.where(small, series, torch.sin(theta_safe) / theta_safe)


def _one_minus_cos_by_theta_sq(theta_sq, theta):
    small = theta_sq < _SMALL_ANGLE**2
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    series = 0.5 - theta_sq / 24.0 + theta_sq * theta_sq / 720.0
    return torch.where(small, series, (1.0 - torch.cos(theta)) / theta_sq_safe)


def exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta_sq)
    a = _sin_by_theta(theta_sq, theta)[..., None, None]
    b = _one_minus_cos_by_theta_sq(theta_sq, theta)[..., None, None]
    k = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(k.shape)
    return eye + a * k + b * (k @ k)


def to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), branchless Shepperd."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack(
        [0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1
    )
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack(
        [(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1
    )
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack(
        [(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1
    )
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack(
        [(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1
    )
    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    use2 = (m11 >= m22)[..., None]
    q = torch.where(use0, q0, torch.where(use1, q1, torch.where(use2, q2, q3)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    # Canonical sign (w >= 0) keeps log continuous around identity.
    return q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)


def log(rot: torch.Tensor) -> torch.Tensor:
    """SO(3) -> so(3) through the quaternion, robust up to theta ~ pi."""
    q = to_quat(rot)
    w, v = q[..., 0], q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < 1e-7
    scale = torch.where(
        small,
        2.0 / torch.clamp(w, min=0.5),
        theta / torch.where(small, torch.ones_like(vnorm), vnorm),
    )
    return v * scale[..., None]


def from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> (..., 3, 3) rotation."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )



def theta(rot: torch.Tensor) -> torch.Tensor:
    """Rotation angle in [0, pi]."""
    return torch.linalg.norm(log(rot), dim=-1)


def is_rotation_matrix(rot: torch.Tensor, atol: float = 1e-5) -> torch.Tensor:
    """True where ``rot`` is orthogonal with determinant +1."""
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    resid = torch.abs(rot @ rot.transpose(-1, -2) - eye)
    orth = torch.amax(resid, dim=(-2, -1)) < atol
    return orth & (torch.abs(torch.linalg.det(rot) - 1.0) < atol)


def wrap_angle(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi)."""
    return torch.remainder(angle + torch.pi, 2.0 * torch.pi) - torch.pi
