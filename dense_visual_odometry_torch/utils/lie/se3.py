"""SE(3) as branchless torch functions over (..., 4, 4) homogeneous matrices.

Same formulas and series thresholds as
``dense_visual_odometry_tpu/utils/lie/se3.py``.  Twist convention
``xi = (upsilon, phi)``: translation first.
"""

from __future__ import annotations

import torch

from dense_visual_odometry_torch.utils.lie import so3

_SMALL_ANGLE = 1e-2
# D = (1 - A/(2B))/theta^2 cancels catastrophically below ~0.1 in f32.
_SMALL_ANGLE_D = 1e-1


def _v_coefficients(theta_sq, theta):
    """B = (1 - cos t)/t^2 and C = (t - sin t)/t^3 with series fallbacks."""
    small = theta_sq < _SMALL_ANGLE**2
    t_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    t_safe = torch.where(small, torch.ones_like(theta), theta)
    b = torch.where(
        small,
        0.5 - theta_sq / 24.0 + theta_sq * theta_sq / 720.0,
        (1.0 - torch.cos(t_safe)) / t_sq_safe,
    )
    c = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0 + theta_sq * theta_sq / 5040.0,
        (t_safe - torch.sin(t_safe)) / (t_sq_safe * t_safe),
    )
    return b, c


def left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """V(phi) = I + B hat(phi) + C hat(phi)^2."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta_sq)
    b, c = _v_coefficients(theta_sq, theta)
    k = so3.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(k.shape)
    return eye + b[..., None, None] * k + c[..., None, None] * (k @ k)


def left_jacobian_inverse(phi: torch.Tensor) -> torch.Tensor:
    """V(phi)^-1 = I - hat(phi)/2 + D hat(phi)^2."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta_sq)
    small = theta_sq < _SMALL_ANGLE_D**2
    t_safe = torch.where(small, torch.ones_like(theta), theta)
    t_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    a = torch.sin(t_safe) / t_safe
    b = (1.0 - torch.cos(t_safe)) / t_sq_safe
    d = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0 + theta_sq * theta_sq * (31.0 / 60480.0),
        (1.0 - a / (2.0 * b)) / t_sq_safe,
    )
    k = so3.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(k.shape)
    return eye - 0.5 * k + d[..., None, None] * (k @ k)


def from_rt(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(rot.shape[:-2], t.shape[:-1])
    out = torch.zeros(batch + (4, 4), dtype=rot.dtype, device=rot.device)
    out[..., :3, :3] = rot
    out[..., :3, 3] = t
    out[..., 3, 3].fill_(1.0)  # fill_: assigning a number to a 0-dim CUDA view syncs
    return out


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) -> SE(3): (..., 6) twist -> (..., 4, 4), t = V(phi) upsilon."""
    upsilon, phi = xi[..., :3], xi[..., 3:]
    rot = so3.exp(phi)
    t = torch.einsum("...ij,...j->...i", left_jacobian(phi), upsilon)
    return from_rt(rot, t)


def log(transform: torch.Tensor) -> torch.Tensor:
    """SE(3) -> se(3): (..., 4, 4) -> (..., 6) twist."""
    phi = so3.log(transform[..., :3, :3])
    upsilon = torch.einsum(
        "...ij,...j->...i", left_jacobian_inverse(phi), transform[..., :3, 3]
    )
    return torch.cat([upsilon, phi], dim=-1)


def hat(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist (..., 6) -> its (..., 4, 4) matrix [[hat(phi), upsilon], [0, 0]]."""
    out = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    out[..., :3, :3] = so3.hat(xi[..., 3:])
    out[..., :3, 3] = xi[..., :3]
    return out


def identity(dtype=torch.float32, batch_shape: tuple = (), device=None) -> torch.Tensor:
    """(*batch_shape, 4, 4) identity transforms."""
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch_shape) + (4, 4))


def inverse(transform: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse [R^T, -R^T t]."""
    rot_t = transform[..., :3, :3].transpose(-1, -2)
    new_t = -torch.einsum("...ij,...j->...i", rot_t, transform[..., :3, 3])
    return from_rt(rot_t, new_t)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Group product a @ b."""
    return a @ b


def transform_points(transform: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply SE(3) (..., 4, 4) to (..., N, 3) points."""
    rot = transform[..., :3, :3]
    t = transform[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", rot, points) + t[..., None, :]


def adjoint(transform: torch.Tensor) -> torch.Tensor:
    """Ad_T (..., 6, 6) for twists (upsilon, phi): [[R, hat(t) @ R], [0, R]],
    so that exp(Ad_T xi) = T exp(xi) T^-1."""
    rot = transform[..., :3, :3]
    out = torch.zeros(transform.shape[:-2] + (6, 6), dtype=transform.dtype,
                      device=transform.device)
    out[..., :3, :3] = rot
    out[..., :3, 3:] = so3.hat(transform[..., :3, 3]) @ rot
    out[..., 3:, 3:] = rot
    return out


def from_quat_t(quat_wxyz: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return from_rt(so3.from_quat(quat_wxyz), t)


def to_quat_t(transform: torch.Tensor):
    """-> ((w, x, y, z) quaternion, translation)."""
    return so3.to_quat(transform[..., :3, :3]), transform[..., :3, 3]
