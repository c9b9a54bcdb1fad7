"""Photometric residuals, the 6-DoF Jacobian and the normal equations.

Counterpart of ``dense_visual_odometry_tpu/ops/residuals.py`` without
the depth term.  Every function takes batched tensors:
images (B, H, W), intrinsics (3, 3) or (B, 3, 3), transforms (B, 4, 4).
Jacobian convention: left-multiplicative update ``T <- exp(delta) @ T``,
twist (upsilon, phi), warp Jacobian evaluated at the transformed point.
The 3x3 rigid transform of the points is written out term by term (no
GEMM), so every device sums it in the reference's order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dense_visual_odometry_torch.ops.cuda.stackwarp import shift_stack_sample_cuda
from dense_visual_odometry_torch.ops.interp import (
    bilinear_sample,
    bilinear_sample_packed,
    nearest_sample_packed,
)


class ResidualSystem(NamedTuple):
    """Per-element linearised system: (B, 6, 6), (B, 6), (B,), (B,)."""

    hessian: torch.Tensor
    rhs: torch.Tensor
    error: torch.Tensor
    count: torch.Tensor


def _k(intrinsics: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Entry (i, j) of (3, 3) or (B, 3, 3) intrinsics, broadcastable to (B, H, W)."""
    return intrinsics[..., i, j][..., None, None]


def inverse_intrinsics(intrinsics: torch.Tensor) -> torch.Tensor:
    """K^-1 of (3, 3) or (B, 3, 3) intrinsics, on their device.

    Inverted on the CPU whatever the device: LAPACK and the GPU's batched
    solver round differently, and under the identity warp a template pixel
    on the image border projects onto the bounds test's edge, where the last
    bit of a ray decides its validity.
    """
    return torch.linalg.inv(intrinsics.cpu()).to(intrinsics.device)


def deproject_grid(
    depth_m: torch.Tensor, intrinsics: torch.Tensor, grid_stride: int = 1
) -> torch.Tensor:
    """Camera-frame points (B, H, W, 3) of a stride-s grid of metric depth."""
    h, w = depth_m.shape[-2], depth_m.shape[-1]
    k_inv = inverse_intrinsics(intrinsics)
    u = torch.arange(w, dtype=torch.float32, device=depth_m.device) * grid_stride
    v = torch.arange(h, dtype=torch.float32, device=depth_m.device) * grid_stride
    ray_x = _k(k_inv, 0, 0) * u[None, :] + _k(k_inv, 0, 1) * v[:, None] + _k(k_inv, 0, 2)
    ray_y = _k(k_inv, 1, 0) * u[None, :] + _k(k_inv, 1, 1) * v[:, None] + _k(k_inv, 1, 2)
    return torch.stack([ray_x * depth_m, ray_y * depth_m, depth_m], dim=-1)


def _jacobian_components(points, grad_x, grad_y, fx, fy, valid):
    """The six per-pixel entries of grad^T @ J_w, as a list of planes."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    z_safe = torch.where(valid, z, torch.ones_like(z))
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    gx = grad_x * fx[..., None, None]
    gy = grad_y * fy[..., None, None]
    j0 = gx * inv_z
    j1 = gy * inv_z
    j2 = -(gx * x + gy * y) * inv_z2
    j3 = -gx * x * y * inv_z2 - gy * (1.0 + y * y * inv_z2)
    j4 = gx * (1.0 + x * x * inv_z2) + gy * x * y * inv_z2
    j5 = -gx * y * inv_z + gy * x * inv_z
    return [j0, j1, j2, j3, j4, j5]


def warp_jacobian_times_grad(points, grad_x, grad_y, fx, fy, valid) -> torch.Tensor:
    """(B, H, W, 6) rows grad^T @ J_w, zero where ``valid`` is False."""
    jac = torch.stack(
        _jacobian_components(points, grad_x, grad_y, fx, fy, valid), dim=-1
    )
    return torch.where(valid[..., None], jac, torch.zeros_like(jac))


def warp_geometry(depth_prev_m, intrinsics, transform, grid_stride=1):
    """Deproject -> transform -> project.

    -> (pts_t (B, H, W, 3), u, v, valid_geom): full-resolution subpixel
    sample coordinates in the current image and depth-valid & in-front.
    """
    points = deproject_grid(depth_prev_m, intrinsics, grid_stride)
    depth_valid = depth_prev_m > 0.0
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]

    def m(i, j):
        return transform[..., i, j][..., None, None]

    xt = m(0, 0) * px + m(0, 1) * py + m(0, 2) * pz + m(0, 3)
    yt = m(1, 0) * px + m(1, 1) * py + m(1, 2) * pz + m(1, 3)
    zc = m(2, 0) * px + m(2, 1) * py + m(2, 2) * pz + m(2, 3)
    pts_t = torch.stack([xt, yt, zc], dim=-1)
    in_front = zc > 1e-6
    z_safe = torch.where(in_front, zc, torch.ones_like(zc))
    # Skew-free pinhole projection (the closed-form Jacobian assumes it).
    u = (_k(intrinsics, 0, 0) * xt + _k(intrinsics, 0, 2) * zc) / z_safe
    v = (_k(intrinsics, 1, 1) * yt + _k(intrinsics, 1, 2) * zc) / z_safe
    return pts_t, u, v, depth_valid & in_front


def _residuals_and_jacobian(
    gray_prev, intrinsics, pts_t, valid, warped, precomputed_jacobian, sample_grads,
):
    """The residuals of a warp sampled into ``warped`` and their Jacobian:
    ``precomputed_jacobian`` (B, H', W', 6), or exact, from the current
    image's gradients at the warp that ``sample_grads()`` returns.
    -> (residuals, jacobian, valid), zero outside ``valid``."""
    residuals = torch.where(valid, warped - gray_prev, torch.zeros_like(warped))
    if precomputed_jacobian is not None:
        jacobian = torch.where(
            valid[..., None], precomputed_jacobian,
            torch.zeros_like(precomputed_jacobian),
        )
    else:
        gx, gy = sample_grads()
        jacobian = warp_jacobian_times_grad(
            pts_t, gx, gy, intrinsics[..., 0, 0], intrinsics[..., 1, 1], valid
        )
    return residuals, jacobian, valid


def warp_residuals(
    gray_prev: torch.Tensor,
    depth_prev_m: torch.Tensor,
    gray_curr: torch.Tensor,
    intrinsics: torch.Tensor,
    transform: torch.Tensor,
    grad_x_curr: Optional[torch.Tensor] = None,
    grad_y_curr: Optional[torch.Tensor] = None,
    precomputed_jacobian: Optional[torch.Tensor] = None,
    grid_stride: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residuals + Jacobian with the current image sampled bilinearly.

    The Jacobian is ``precomputed_jacobian`` (B, H', W', 6) or exact: the
    current image's gradients ``grad_x_curr`` / ``grad_y_curr`` (B, H, W)
    sampled bilinearly at the warp, times the warp Jacobian at the
    transformed points.  -> (residuals, jacobian (B, H', W', 6), valid),
    zero outside ``valid``.
    """
    pts_t, u, v, valid_geom = warp_geometry(
        depth_prev_m, intrinsics, transform, grid_stride
    )
    warped, warp_ok = bilinear_sample(gray_curr, u, v)
    return _residuals_and_jacobian(
        gray_prev, intrinsics, pts_t, valid_geom & warp_ok, warped, precomputed_jacobian,
        lambda: (bilinear_sample(grad_x_curr, u, v)[0], bilinear_sample(grad_y_curr, u, v)[0]),
    )


def warp_residuals_packed(
    gray_prev: torch.Tensor,
    depth_prev_m: torch.Tensor,
    gray_curr_packed: torch.Tensor,
    intrinsics: torch.Tensor,
    transform: torch.Tensor,
    grads_packed: Optional[torch.Tensor] = None,
    precomputed_jacobian: Optional[torch.Tensor] = None,
    grid_stride: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residuals + Jacobian through the packed planes.

    ``gray_curr_packed`` is a ``pack_neighbors`` plane sampled bilinearly;
    the Jacobian is either ``precomputed_jacobian`` (B, H', W', 6) or exact,
    from the ``pack_pair_f16`` (gx, gy) plane ``grads_packed`` sampled
    nearest at the warp.  -> (residuals, jacobian (B, H', W', 6), valid),
    zero outside ``valid``.
    """
    pts_t, u, v, valid_geom = warp_geometry(
        depth_prev_m, intrinsics, transform, grid_stride
    )
    warped, warp_ok = bilinear_sample_packed(gray_curr_packed, u, v)
    return _residuals_and_jacobian(
        gray_prev, intrinsics, pts_t, valid_geom & warp_ok, warped, precomputed_jacobian,
        lambda: nearest_sample_packed(grads_packed, u, v)[:2],
    )


def warp_residuals_shift(
    gray_prev: torch.Tensor,
    depth_prev_m: torch.Tensor,
    gray_curr: torch.Tensor,
    intrinsics: torch.Tensor,
    transform: torch.Tensor,
    grads_packed: Optional[torch.Tensor] = None,
    precomputed_jacobian: Optional[torch.Tensor] = None,
    grid_stride: int = 1,
    radius: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residuals + Jacobian with the current image sampled through the
    recentred shift window: valid while the displacement from the window
    centre stays inside the radius-``radius`` ball.

    The current image is sampled by the stack kernel
    (:func:`~dense_visual_odometry_torch.ops.cuda.stackwarp.shift_stack_sample_cuda`;
    its plain version on CPU tensors).
    The Jacobian is ``precomputed_jacobian`` (B, H', W', 6) or exact, from
    the ``pack_pair_f16`` (gx, gy) plane ``grads_packed`` sampled nearest.
    -> (residuals, jacobian (B, H', W', 6), valid), zero outside ``valid``.
    """
    pts_t, u, v, valid_geom = warp_geometry(
        depth_prev_m, intrinsics, transform, grid_stride
    )
    warped, warp_ok = shift_stack_sample_cuda(
        gray_curr, u, v, radius, grid_stride, valid_geom
    )
    return _residuals_and_jacobian(
        gray_prev, intrinsics, pts_t, valid_geom & warp_ok, warped, precomputed_jacobian,
        lambda: nearest_sample_packed(grads_packed, u, v)[:2],
    )


def approximate_jacobian_planes(
    depth_prev_m: torch.Tensor,
    intrinsics: torch.Tensor,
    grad_x_prev: torch.Tensor,
    grad_y_prev: torch.Tensor,
    grid_stride: int = 1,
) -> torch.Tensor:
    """Constant (inverse-compositional) Jacobian as 6 leading planes.

    Inputs on the stride-``grid_stride`` grid -> (B, 6, H', W'), zero at
    invalid depth.
    """
    points = deproject_grid(depth_prev_m, intrinsics, grid_stride)
    valid = depth_prev_m > 0.0
    jac = torch.stack(
        _jacobian_components(
            points, grad_x_prev, grad_y_prev,
            intrinsics[..., 0, 0], intrinsics[..., 1, 1], valid,
        ),
        dim=-3,
    )
    return torch.where(valid[..., None, :, :], jac, torch.zeros_like(jac))


def approximate_jacobian(
    depth_prev_m: torch.Tensor,
    intrinsics: torch.Tensor,
    grad_x_prev: torch.Tensor,
    grad_y_prev: torch.Tensor,
    grid_stride: int = 1,
) -> torch.Tensor:
    """:func:`approximate_jacobian_planes` in the trailing layout
    (B, H', W', 6).  The JAX package builds it at full resolution and
    strides it; its terms are elementwise and the strided grid deprojects
    to the same floats, so building it on the strided grid gives the same
    values (``tests/test_torch_warp_residuals.py``)."""
    return approximate_jacobian_planes(
        depth_prev_m, intrinsics, grad_x_prev, grad_y_prev, grid_stride
    ).permute(0, 2, 3, 1).contiguous()


def normal_equations(residuals, jacobian, weights, valid) -> ResidualSystem:
    """H = J^T W J, b = -J^T W r, err = sum(w r^2) / count per element."""
    b = jacobian.shape[0]
    jac = jacobian.reshape(b, -1, 6)
    res = residuals.reshape(b, -1)
    wts = weights.reshape(b, -1)
    jw = jac * wts[..., None]
    hess = torch.einsum("bni,bnj->bij", jw, jac)
    rhs = -torch.einsum("bni,bn->bi", jw, res)
    count = torch.sum(valid.reshape(b, -1).to(torch.float32), dim=-1)
    error = torch.sum(wts * res * res, dim=-1) / torch.clamp(count, min=1.0)
    return ResidualSystem(hessian=hess, rhs=rhs, error=error, count=count)
