"""Pyramid step: the 3x3 median at the kept pixels, one launch a level.

No Pallas counterpart: ``dense_visual_odometry_tpu/ops/pyramid.py`` builds
the pyramid in plain jnp.  :func:`median_pyr_down` computes
``median3x3(image)[..., ::2, ::2]``: on CUDA tensors it launches
``csrc/pyramid.cu`` (a thread per output pixel on a 3-D grid of 32 x
8-pixel blocks, the leading dims on z, the same 19 exchanges as
:func:`~dense_visual_odometry_torch.ops.pyramid.median3x3`, so the two agree
element for element); on CPU tensors it runs that plain version.  Any other
device raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dense_visual_odometry_torch.ops import pyramid as pyr_ops
from dense_visual_odometry_torch.ops.cuda import build


def _check_inputs(image: torch.Tensor) -> None:
    if image.dim() < 2:
        raise ValueError(f"image must be (..., H, W), got shape {tuple(image.shape)}")
    if image.dtype != torch.float32:
        raise TypeError(f"image must be float32, got {image.dtype}")
    if not image.is_contiguous():
        raise ValueError("image must be contiguous")
    # The kernel indexes in 32 bits and puts the leading dims on the grid's z.
    lead = math.prod(image.shape[:-2])
    if image.numel() >= 2**31 or lead > 65535:
        raise ValueError(f"median_pyr_down: {tuple(image.shape)} exceeds the kernel's "
                         f"32-bit indexing")


def _launch(image: torch.Tensor) -> torch.Tensor:
    lib = build.load("pyramid")
    fn = lib.dvo_median_pyr_down
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    h, w = image.shape[-2], image.shape[-1]
    out = torch.empty(image.shape[:-2] + ((h + 1) // 2, (w + 1) // 2),
                      dtype=torch.float32, device=image.device)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    status = fn(image.data_ptr(), out.data_ptr(), math.prod(image.shape[:-2]), h, w, stream)
    build.check(status, "pyramid")
    median_pyr_down.launches += 1
    return out


def median_pyr_down(image: torch.Tensor) -> torch.Tensor:
    """One pyramid step of (..., H, W) -> (..., ceil(H/2), ceil(W/2)): the
    3x3 median with replicated borders, at the even rows and columns.  CUDA
    tensors (float32, contiguous) run the kernel, CPU tensors the plain
    version."""
    if image.device.type == "cpu":
        return pyr_ops.median3x3(image)[..., ::2, ::2].contiguous()
    _check_inputs(image)
    if image.device.type == "cuda":
        return _launch(image)
    raise RuntimeError(f"median_pyr_down: no kernel for device {image.device}")


median_pyr_down.launches = 0
