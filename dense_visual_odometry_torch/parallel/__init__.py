"""Batched tracking of independent frame pairs on one GPU."""

from dense_visual_odometry_torch.parallel.batched import (  # noqa: F401
    batched_track_pair,
    stack_frame_data,
)
