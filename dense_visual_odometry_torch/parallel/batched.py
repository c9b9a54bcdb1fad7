"""Batched multi-pair tracking on one GPU.

Counterpart of ``dense_visual_odometry_tpu/parallel/batched.py`` without the
device mesh: B independent frame pairs ride the batch dimension of every
tensor of one solve.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.models.robust import (
    FrameData,
    TrackResult,
    track_pair,
)


def stack_frame_data(frames: Sequence[FrameData]) -> FrameData:
    """Stack per-pair (H, W)-level ``FrameData`` into one (B, H, W) batch."""
    levels = len(frames[0].gray)
    return FrameData(
        gray=tuple(torch.stack([f.gray[lv] for f in frames]) for lv in range(levels)),
        depth_m=tuple(
            torch.stack([f.depth_m[lv] for f in frames]) for lv in range(levels)
        ),
    )


def batched_track_pair(
    prev: FrameData,
    curr: FrameData,
    intrinsics: torch.Tensor,
    cfg: RobustDVOConfig,
    init_guess: Optional[torch.Tensor] = None,
    last_transform: Optional[torch.Tensor] = None,
) -> TrackResult:
    """Track B pairs at once on the device of the pyramids.

    prev / curr: ``FrameData`` with (B, H, W) levels; intrinsics (3, 3)
    shared or (B, 3, 3); init_guess / last_transform optional (B, 4, 4).
    """
    camera = CameraModel(
        intrinsics=torch.as_tensor(intrinsics, dtype=torch.float32).to(
            prev.gray[0].device
        ),
        depth_scale=1.0,
    )
    return track_pair(
        prev, curr, camera, cfg,
        init_guess=init_guess, last_transform=last_transform,
    )
