"""Fused iteration: one photometric evaluation reduced to 56 scalars.

Counterpart of ``dense_visual_odometry_tpu/ops/pallas/fused_iter.py``
(``_fused_kernel`` :56, ``fused_iteration_pallas`` :163,
``fused_shift_iteration`` :239).  :func:`fused_iteration` takes the Pallas
call's argument layout: on CUDA tensors it launches ``csrc/fused_iter.cu``
(one block per batch element), on CPU tensors it runs
:func:`fused_iteration_plain`.  Any other device raises.

The evaluation: tent taps of the frozen window at the given displacements,
residual against the template, optional bias centring, t-scale fixed point,
IRLS weights, and the sums H (36), b (6), err_sum, count, lambda and, with
the bias, s, rho, g (6).  :func:`fused_shift_iteration` wraps it for the
solver with the frozen window and applies the bias Schur on the reduced
scalars.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dense_visual_odometry_torch.ops.cuda import build
from dense_visual_odometry_torch.ops.shiftwarp import (
    residual_displacements,
    tent_sample,
)

OUT_COLS = 56


def fused_iteration_plain(
    planes, du, dv, gray_prev, valid, jac_planes, lam0, radius,
    grid_stride=1, dof=5.0, unroll=3, use_tweights=True,
    normalize_scale=True, illum_bias=False,
) -> torch.Tensor:
    """Plain-PyTorch version of the fused kernel: same inputs, same rows."""
    b = planes.shape[0]
    acc = tent_sample(planes, du, dv, radius, grid_stride)
    vmask = valid > 0.0
    res = torch.where(vmask, acc - gray_prev, torch.zeros_like(acc))
    count = valid.sum(dim=(-2, -1))
    count_safe = torch.clamp(count, min=1.0)
    if illum_bias:
        mu0 = res.sum(dim=(-2, -1)) / count_safe
        res = torch.where(vmask, res - mu0[:, None, None], torch.zeros_like(res))
    rsq = res * res
    lam = lam0[:, 0]
    if use_tweights:
        for _ in range(unroll):
            w_est = (dof + 1.0) / (dof + rsq * lam[:, None, None])
            sigma_sq = (valid * rsq * w_est).sum(dim=(-2, -1))
            if normalize_scale:
                sigma_sq = sigma_sq / count_safe
            lam = 1.0 / torch.clamp(sigma_sq, min=1e-20)
        weights = valid * (dof + 1.0) / (dof + rsq * lam[:, None, None])
    else:
        weights = valid
    jw = [jac_planes[:, i] * weights for i in range(6)]
    out = torch.zeros((b, OUT_COLS), dtype=torch.float32, device=planes.device)
    for i in range(6):
        for j in range(i, 6):
            hij = (jw[i] * jac_planes[:, j]).sum(dim=(-2, -1))
            out[:, i * 6 + j] = hij
            out[:, j * 6 + i] = hij
    for i in range(6):
        out[:, 36 + i] = -(jw[i] * res).sum(dim=(-2, -1))
    out[:, 42] = (weights * rsq).sum(dim=(-2, -1))
    out[:, 43] = count
    out[:, 44] = lam
    if illum_bias:
        out[:, 45] = weights.sum(dim=(-2, -1))
        out[:, 46] = (weights * res).sum(dim=(-2, -1))
        for i in range(6):
            out[:, 47 + i] = jw[i].sum(dim=(-2, -1))
    return out


def _check_inputs(planes, du, dv, gray_prev, valid, jac_planes, lam0,
                  radius, grid_stride):
    b, hp, wp = du.shape
    s = grid_stride
    if s not in (1, 2):
        raise ValueError(f"grid_stride must be 1 or 2, got {s}")
    expect = {
        "planes": (planes, (b, s * s, (2 * radius) // s + hp, (2 * radius) // s + wp)),
        "du": (du, (b, hp, wp)),
        "dv": (dv, (b, hp, wp)),
        "gray_prev": (gray_prev, (b, hp, wp)),
        "valid": (valid, (b, hp, wp)),
        "jac_planes": (jac_planes, (b, 6, hp, wp)),
        "lam0": (lam0, (b, 1)),
    }
    for name, (t, shape) in expect.items():
        if t.device != du.device:
            raise ValueError(f"{name} is on {t.device}, expected {du.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(planes, du, dv, gray_prev, valid, jac_planes, lam0, radius,
            grid_stride, dof, unroll, use_tweights, normalize_scale,
            illum_bias) -> torch.Tensor:
    lib = build.load("fused_iter")
    fn = lib.dvo_fused_iteration
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
        + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    b, hp, wp = du.shape
    ph, pw = planes.shape[-2], planes.shape[-1]
    out = torch.empty((b, OUT_COLS), dtype=torch.float32, device=du.device)
    scratch = torch.empty((b, hp * wp), dtype=torch.float32, device=du.device)
    stream = torch.cuda.current_stream(du.device).cuda_stream
    status = fn(
        planes.data_ptr(), du.data_ptr(), dv.data_ptr(), gray_prev.data_ptr(),
        valid.data_ptr(), jac_planes.data_ptr(), lam0.data_ptr(),
        out.data_ptr(), scratch.data_ptr(),
        b, grid_stride, ph, pw, hp, wp, radius, dof, unroll,
        int(use_tweights), int(normalize_scale), int(illum_bias), stream,
    )
    build.check(status, "fused_iter")
    fused_iteration.launches += 1
    return out


def fused_iteration(
    planes: torch.Tensor,
    du: torch.Tensor,
    dv: torch.Tensor,
    gray_prev: torch.Tensor,
    valid: torch.Tensor,
    jac_planes: torch.Tensor,
    lam0: torch.Tensor,
    radius: int,
    grid_stride: int = 1,
    dof: float = 5.0,
    unroll: int = 3,
    use_tweights: bool = True,
    normalize_scale: bool = True,
    illum_bias: bool = False,
) -> torch.Tensor:
    """One evaluation per element: planes (B, s^2, ph, pw); du, dv,
    gray_prev, valid ({0, 1}) (B, H', W'); jac_planes (B, 6, H', W'); lam0
    (B, 1) -> (B, 56) rows [H 36 | b 6 | err_sum | count | lambda | (bias)
    s | rho | g 6].  Valid pixels must have finite displacements.  CUDA
    tensors run the kernel, CPU tensors the plain version."""
    args = (planes, du, dv, gray_prev, valid, jac_planes, lam0, radius,
            grid_stride, dof, unroll, use_tweights, normalize_scale, illum_bias)
    _check_inputs(planes, du, dv, gray_prev, valid, jac_planes, lam0, radius,
                  grid_stride)
    if du.device.type == "cuda":
        return _launch(*args)
    if du.device.type == "cpu":
        return fused_iteration_plain(*args)
    raise RuntimeError(f"fused_iteration: no kernel for device {du.device}")


fused_iteration.launches = 0


def fused_shift_iteration(
    gray_prev: torch.Tensor,
    gray_curr: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    valid_geom: torch.Tensor,
    jacobian_planes: torch.Tensor,
    lam0: torch.Tensor,
    frozen: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    radius: int,
    grid_stride: int = 1,
    dof: float = 5.0,
    unroll: int = 3,
    use_tweights: bool = True,
    normalize_scale: bool = True,
    illum_bias: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """One fused evaluation through a frozen window.

    gray_prev (B, H', W') template; gray_curr (B, H, W) current image (for
    its bounds); u, v (B, H', W') warp coordinates; valid_geom bool;
    jacobian_planes (B, 6, H', W'); lam0 (B,); frozen = (planes, cu, cv)
    extracted at the level's start.  -> (hessian (B, 6, 6), rhs (B, 6),
    error (B,), count (B,), lambda (B,)).
    """
    planes, cu, cv = frozen
    du, dv, valid = residual_displacements(
        u, v, cu, cv, radius, grid_stride,
        gray_curr.shape[-2], gray_curr.shape[-1],
    )
    valid = valid & valid_geom
    out = fused_iteration(
        planes.to(torch.float32).contiguous(), du.contiguous(), dv.contiguous(),
        gray_prev.to(torch.float32).contiguous(),
        valid.to(torch.float32).contiguous(),
        jacobian_planes.to(torch.float32).contiguous(),
        lam0.to(torch.float32).reshape(-1, 1).contiguous(),
        radius=radius, grid_stride=grid_stride, dof=dof, unroll=unroll,
        use_tweights=use_tweights, normalize_scale=normalize_scale,
        illum_bias=illum_bias,
    )
    hess = out[:, :36].reshape(-1, 6, 6)
    rhs = out[:, 36:42]
    count = out[:, 43]
    err_sum = out[:, 42]
    if illum_bias:
        # Exact Schur elimination of the exposure bias on the reduced
        # scalars: H' = H - g g^T / s, b' = b + g rho / s, err' = err - rho^2/s.
        s_safe = torch.clamp(out[:, 45], min=1e-6)
        rho = out[:, 46]
        g = out[:, 47:53]
        hess = hess - g[:, :, None] * g[:, None, :] / s_safe[:, None, None]
        rhs = rhs + g * (rho / s_safe)[:, None]
        err_sum = err_sum - rho * rho / s_safe
    err = err_sum / torch.clamp(count, min=1.0)
    return hess, rhs, err, count, out[:, 44]
