"""Batched multi-pair tracking on one GPU.

Counterpart of ``dense_visual_odometry_tpu/parallel/batched.py`` without the
device mesh: B independent frame pairs ride the batch dimension of every
tensor of one solve.  :func:`make_batched_tracker` and
:func:`pad_batch_to_devices` keep the JAX package's calls; on one GPU the
tracker is :func:`batched_track_pair` with its configuration bound.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

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


def make_batched_tracker(cfg: RobustDVOConfig) -> Callable[..., TrackResult]:
    """-> ``run(prev, curr, intrinsics, **kw)``: :func:`batched_track_pair`
    under ``cfg`` (the JAX package's tracker without a mesh)."""

    def run(prev, curr, intrinsics, **kw):
        return batched_track_pair(prev, curr, intrinsics, cfg, **kw)

    return run


def pad_batch_to_devices(frames, n_devices: int) -> Tuple[list, int]:
    """Pad a list of per-pair items so the batch divides ``n_devices``:
    -> (padded list, original length).  Padding repeats the last pair;
    callers slice results back to the original length."""
    orig = len(frames)
    if orig == 0:
        raise ValueError("empty batch")
    rem = (-orig) % n_devices
    return list(frames) + [frames[-1]] * rem, orig
