"""Stack warp: the frozen window sampled at per-pixel displacements.

Counterpart of ``dense_visual_odometry_tpu/ops/pallas/stackwarp.py``
(``_stack_kernel`` :38, ``stack_accumulate_pallas`` :85,
``shift_stack_sample_pallas`` :735).  :func:`stack_accumulate` takes the
Pallas call's argument layout: on CUDA tensors it launches
``csrc/stackwarp.cu`` (a thread per output pixel on a 3-D grid of
32 x 8-pixel blocks, no index division at strides 1 and 2, one variant
that divides for every stride >= 3); on CPU tensors it runs
the plain version, :func:`~dense_visual_odometry_torch.ops.shiftwarp.tent_sample`,
which the kernel's ``dvo::tent_sample`` follows tap for tap.  Any other
device raises.

The solver uses it twice: :func:`shift_stack_sample_cuda` samples the
current image in the "shift" evaluation mode, and the ESM gradients sample
the already-extracted frozen window of a level once
(``models/robust.py``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dense_visual_odometry_torch.ops.cuda import build
from dense_visual_odometry_torch.ops.shiftwarp import prepare_shift_stack, tent_sample


def _check_inputs(planes, du, dv, radius, grid_stride):
    b, hp, wp = du.shape
    s = grid_stride
    if s < 1:
        raise ValueError(f"grid_stride must be >= 1, got {s}")
    expect = {
        "planes": (planes, (b, s * s, (2 * radius) // s + hp, (2 * radius) // s + wp)),
        "du": (du, (b, hp, wp)),
        "dv": (dv, (b, hp, wp)),
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


def _launch(planes, du, dv, radius, grid_stride) -> torch.Tensor:
    lib = build.load("stackwarp")
    fn = lib.dvo_stack_accumulate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    b, hp, wp = du.shape
    ph, pw = planes.shape[-2], planes.shape[-1]
    # The kernel indexes in 32 bits and puts the batch on the grid's z.
    if max(planes.numel(), du.numel()) >= 2**31 or b > 65535:
        raise ValueError(f"stack_accumulate: batch {b} of {tuple(planes.shape[1:])} "
                         f"planes exceeds the kernel's 32-bit indexing")
    out = torch.empty((b, hp, wp), dtype=torch.float32, device=du.device)
    stream = torch.cuda.current_stream(du.device).cuda_stream
    status = fn(
        planes.data_ptr(), du.data_ptr(), dv.data_ptr(), out.data_ptr(),
        b, grid_stride, ph, pw, hp, wp, radius, stream,
    )
    build.check(status, "stackwarp")
    stack_accumulate.launches += 1
    if grid_stride >= 3:
        stack_accumulate.runtime_stride_launches += 1
    return out


def stack_accumulate(
    planes: torch.Tensor,
    du: torch.Tensor,
    dv: torch.Tensor,
    radius: int,
    grid_stride: int,
) -> torch.Tensor:
    """Tent-weighted taps of parity planes (B, s^2, ph, pw) at the
    centre-relative displacements du, dv (B, H', W') -> (B, H', W').
    Taps outside [-r, r] carry no weight; validity is the caller's.  CUDA
    tensors run the kernel, CPU tensors the plain version."""
    _check_inputs(planes, du, dv, radius, grid_stride)
    if du.device.type == "cuda":
        return _launch(planes, du, dv, radius, grid_stride)
    if du.device.type == "cpu":
        return tent_sample(planes, du, dv, radius, grid_stride)
    raise RuntimeError(f"stack_accumulate: no kernel for device {du.device}")


stack_accumulate.launches = 0
stack_accumulate.runtime_stride_launches = 0  # of them, at a grid stride >= 3


def shift_stack_sample_cuda(
    image: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    radius: int,
    grid_stride: int,
    coord_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample image (B, H, W) at the full-resolution coordinates u, v
    (B, H', W') of a stride-s grid through the stack kernel: recentre,
    extract the parity planes, accumulate.  ``coord_mask`` marks the pixels
    whose coordinates enter the recentring mean.  -> (values, 0 where
    invalid; valid: in bounds and inside the ball)."""
    planes, du, dv, valid = prepare_shift_stack(
        image, u, v, radius, grid_stride, coord_mask
    )
    acc = stack_accumulate(planes, du.contiguous(), dv.contiguous(), radius, grid_stride)
    return torch.where(valid, acc, torch.zeros_like(acc)), valid
