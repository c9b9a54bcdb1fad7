"""3x3 Sobel gradients with symmetric borders (cv2.BORDER_REFLECT)."""

from __future__ import annotations

from typing import Tuple

import torch


def _pad_symmetric(image: torch.Tensor) -> torch.Tensor:
    """Pad the last two axes by one, duplicating the edge pixel."""
    img = torch.cat([image[..., :1, :], image, image[..., -1:, :]], dim=-2)
    return torch.cat([img[..., :1], img, img[..., -1:]], dim=-1)


def sobel(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) of an (..., H, W) image, as correlations with
    gx = [[-1,0,1],[-2,0,2],[-1,0,1]] and gy = gx^T (raw gain 8)."""
    img = _pad_symmetric(image.to(torch.float32))
    h, w = image.shape[-2], image.shape[-1]

    def win(dy: int, dx: int) -> torch.Tensor:
        return img[..., dy : dy + h, dx : dx + w]

    smooth_rows = (
        win(0, 0) + 2.0 * win(1, 0) + win(2, 0),
        win(0, 1) + 2.0 * win(1, 1) + win(2, 1),
        win(0, 2) + 2.0 * win(1, 2) + win(2, 2),
    )
    gx = smooth_rows[2] - smooth_rows[0]
    smooth_cols = (
        win(0, 0) + 2.0 * win(0, 1) + win(0, 2),
        win(1, 0) + 2.0 * win(1, 1) + win(1, 2),
        win(2, 0) + 2.0 * win(2, 1) + win(2, 2),
    )
    gy = smooth_cols[2] - smooth_cols[0]
    return gx, gy
