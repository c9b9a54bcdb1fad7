"""Batched tracking of independent frame pairs on one GPU."""

from dense_visual_odometry_torch.parallel.batched import (  # noqa: F401
    batched_track_pair,
    make_batched_tracker,
    pad_batch_to_devices,
    stack_frame_data,
)
