"""Fused evaluation: one photometric evaluation of a pose, reduced to its
6x6 system, in one kernel launch.

Counterpart of ``dense_visual_odometry_tpu/ops/pallas/fused_iter.py``
(``_fused_kernel`` :56, ``fused_shift_iteration`` :239, frozen-window
branch).  :func:`fused_evaluation` takes the level kernel's inputs
(``level_solver.level_inputs``' layout) and evaluates the pose and t-scale
lambda of their scalar row: on CUDA tensors it launches
``csrc/fused_iter.cu`` (each batch element on a cluster of CTAs, sized by
``level_solver.level_geometry`` for :data:`FUSED_KERNEL`), on CPU
tensors it runs :func:`fused_evaluation_plain`, which is the level
kernel's plain evaluation (``level_solver.level_evaluation``).  Any other
device raises.

The evaluation: warp of the template points, ball / in-bounds / in-front
masks, tent taps of the frozen window, residual against the template,
optional bias centring, t-scale fixed point, IRLS weights, the weighted
normal equations and the bias Schur.  :func:`fused_shift_iteration` wraps
it for the solver: the level-0 Hessian at the solved pose, on the level's
own inputs.  Its settings are a projection of the level kernel's
(:func:`fused_settings`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dense_visual_odometry_torch.ops.cuda import build
from dense_visual_odometry_torch.ops.cuda.level_solver import (
    ILLUM_BIAS,
    ILLUM_NONE,
    IN_COLS,
    ClusterKernel,
    LevelGeometry,
    LevelInputs,
    _PAIRS,
    check_inputs,
    launch_geometry,
    level_evaluation,
)

OUT_COLS = 48
# Only the residuals stay in shared memory (csrc/fused_iter.cu).  One
# evaluation reads its inputs once: one wave of clusters beats two waves of
# larger ones (PERF.md).
FUSED_KERNEL = ClusterKernel("fused_iter", 1, one_wave=True)
# The level kernel's settings that the fused kernel takes too, by name.
FUSED_SETTINGS = ("radius", "grid_stride", "dof", "unroll", "use_tweights", "normalize_scale",
                  "illum_bias")


def fused_settings(settings: dict) -> dict:
    """The fused kernel's keyword arguments among ``settings``, the level
    kernel's (``level_solver.lm_level``'s names)."""
    return {name: settings[name] for name in FUSED_SETTINGS}


def fused_evaluation_plain(
    planes, points, gray_prev, jac_planes, scal, radius, grid_stride,
    image_h, image_w, dof=5.0, unroll=3, use_tweights=True,
    normalize_scale=True, illum_bias=False,
) -> torch.Tensor:
    """Plain-PyTorch version of the fused kernel: same inputs, same
    (B, 48) rows."""
    b = points.shape[0]
    est = tuple(scal[:, k] for k in range(12))
    h21, rhs, err, count, lam = level_evaluation(
        planes, points, gray_prev, jac_planes, scal, est, scal[:, 32], radius,
        grid_stride, image_h, image_w, dof, unroll, use_tweights,
        normalize_scale, illum_bias,
    )
    out = torch.zeros((b, OUT_COLS), dtype=torch.float32, device=points.device)
    for (i, j), h in zip(_PAIRS, h21):
        out[:, i * 6 + j] = h
        out[:, j * 6 + i] = h
    out[:, 36:42] = torch.stack(rhs, dim=1)
    out[:, 42] = err
    out[:, 43] = count
    out[:, 44] = lam
    return out


def _launch(planes, points, gray_prev, jac_planes, scal, radius, grid_stride,
            image_h, image_w, dof, unroll, use_tweights, normalize_scale,
            illum_bias, geometry: Optional[LevelGeometry] = None) -> torch.Tensor:
    """Launch the kernel, at ``geometry`` or at ``launch_geometry``'s."""
    if geometry is None:
        geometry = launch_geometry(points, grid_stride, illum_bias, kernel=FUSED_KERNEL)
    fn = build.load("fused_iter").dvo_fused_evaluation
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
        + [ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    b, _, hp, wp = points.shape
    ph, pw = planes.shape[-2], planes.shape[-1]
    out = torch.empty((b, OUT_COLS), dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    status = fn(
        planes.data_ptr(), points.data_ptr(), gray_prev.data_ptr(),
        jac_planes.data_ptr(), scal.data_ptr(), out.data_ptr(),
        b, grid_stride, ph, pw, hp, wp, IN_COLS, radius, image_h, image_w,
        dof, unroll, int(use_tweights), int(normalize_scale),
        ILLUM_BIAS if illum_bias else ILLUM_NONE, geometry.cluster, geometry.band_stride,
        geometry.dynamic_bytes, stream,
    )
    build.check(status, "fused_iter")
    fused_evaluation.launches += 1
    if grid_stride >= 3:
        fused_evaluation.runtime_stride_launches += 1
    return out


def fused_evaluation(
    planes: torch.Tensor,
    points: torch.Tensor,
    gray_prev: torch.Tensor,
    jac_planes: torch.Tensor,
    scal: torch.Tensor,
    radius: int,
    grid_stride: int,
    image_h: int,
    image_w: int,
    dof: float = 5.0,
    unroll: int = 3,
    use_tweights: bool = True,
    normalize_scale: bool = True,
    illum_bias: bool = False,
) -> torch.Tensor:
    """One evaluation per element of the pose ``scal[:, 0:16]`` with the
    t-scale warm-started at ``scal[:, 32]``, on the level kernel's inputs
    (``level_solver.lm_level``'s layout) -> (B, 48) rows [H 6x6 row-major
    | rhs 6 | err | count | lambda | 0 0 0], the bias Schur applied.  CUDA
    tensors run the kernel, CPU tensors the plain version."""
    args = (planes, points, gray_prev, jac_planes, scal, radius, grid_stride,
            image_h, image_w, dof, unroll, use_tweights, normalize_scale, illum_bias)
    check_inputs(planes, points, gray_prev, jac_planes, scal, grid_stride, radius)
    if points.device.type == "cuda":
        return _launch(*args)
    if points.device.type == "cpu":
        return fused_evaluation_plain(*args)
    raise RuntimeError(f"fused_evaluation: no kernel for device {points.device}")


fused_evaluation.launches = 0
fused_evaluation.runtime_stride_launches = 0  # of them, at a grid stride >= 3


def fused_shift_iteration(
    inputs: LevelInputs,
    est: torch.Tensor,
    wlam: torch.Tensor,
    radius: int,
    grid_stride: int,
    image_h: int,
    image_w: int,
    dof: float = 5.0,
    unroll: int = 3,
    use_tweights: bool = True,
    normalize_scale: bool = True,
    illum_bias: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """One fused evaluation of ``est`` (B, 4, 4) with the t-scale
    warm-started at ``wlam`` (B,), on a level's inputs
    (``level_solver.LevelInputs``): its frozen window, template points,
    template and Jacobian planes; only the pose and lambda of the scalar row
    change.  -> (hessian (B, 6, 6), rhs (B, 6), error (B,),
    count (B,), lambda (B,))."""
    b = est.shape[0]
    scal = torch.cat(
        [est.reshape(b, 16), inputs.scal[:, 16:32], wlam.reshape(b, 1), inputs.scal[:, 33:]],
        dim=1,
    )
    out = fused_evaluation(
        inputs.planes, inputs.points, inputs.gray_prev, inputs.jac_planes, scal,
        radius=radius, grid_stride=grid_stride, image_h=image_h, image_w=image_w,
        dof=dof, unroll=unroll, use_tweights=use_tweights,
        normalize_scale=normalize_scale, illum_bias=illum_bias,
    )
    return out[:, :36].reshape(b, 6, 6), out[:, 36:42], out[:, 42], out[:, 43], out[:, 44]
