"""Image pyramid: 3x3 median smoothing + decimation.

A level is ``median3x3(previous)[::2, ::2]`` with replicated borders
(cv2.medianBlur semantics); the median is the 19-exchange median-of-9
selection network of ``dense_visual_odometry_tpu/ops/pyramid.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _shift_stack_3x3(image: torch.Tensor) -> list:
    """The 9 replicate-padded 3x3-neighbourhood planes of (..., H, W)."""
    h, w = image.shape[-2], image.shape[-1]
    lead = image.shape[:-2]
    flat = image.reshape((-1, 1, h, w))
    padded = F.pad(flat, (1, 1, 1, 1), mode="replicate").reshape(
        lead + (h + 2, w + 2)
    )
    return [
        padded[..., dy : dy + h, dx : dx + w]
        for dy in range(3)
        for dx in range(3)
    ]


def median3x3(image: torch.Tensor) -> torch.Tensor:
    """3x3 median filter with replicated borders."""
    p = _shift_stack_3x3(image)

    def cx(i: int, j: int) -> None:
        lo = torch.minimum(p[i], p[j])
        hi = torch.maximum(p[i], p[j])
        p[i], p[j] = lo, hi

    cx(1, 2); cx(4, 5); cx(7, 8)  # noqa: E702
    cx(0, 1); cx(3, 4); cx(6, 7)  # noqa: E702
    cx(1, 2); cx(4, 5); cx(7, 8)  # noqa: E702
    cx(0, 3); cx(5, 8); cx(4, 7)  # noqa: E702
    cx(3, 6); cx(1, 4); cx(2, 5)  # noqa: E702
    cx(4, 7); cx(4, 2); cx(6, 4)  # noqa: E702
    cx(4, 2)
    return p[4]


def pyr_down(image: torch.Tensor) -> torch.Tensor:
    """One pyramid step: median smooth, then keep even rows/columns."""
    return median3x3(image)[..., ::2, ::2].contiguous()


def build_pyramid(image: torch.Tensor, levels: int) -> Tuple[torch.Tensor, ...]:
    """``out[0]`` is the input, ``out[l]`` halves ``out[l-1]``."""
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    out = [image]
    for _ in range(1, levels):
        out.append(pyr_down(out[-1]))
    return tuple(out)


def rgb_to_gray(rgb: torch.Tensor, quantize: bool = False) -> torch.Tensor:
    """ITU-R BT.601 luma of (..., H, W, 3) RGB, float32 in [0, 255]."""
    rgb = rgb.to(torch.float32)
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    if quantize:
        gray = torch.round(gray)
    return gray


def preprocess_depth(
    depth_raw: torch.Tensor, depth_scale: float, max_distance: float = 5.0
) -> torch.Tensor:
    """Raw depth DN -> meters, with points beyond ``max_distance`` zeroed."""
    z = depth_raw.to(torch.float32) * depth_scale
    return torch.where(z > max_distance, torch.zeros_like(z), z)
