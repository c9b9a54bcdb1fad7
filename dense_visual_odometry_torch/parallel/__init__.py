"""Batched tracking of independent frame pairs, on one GPU or sharded over
ranks (one process per device), and the distributed back end."""

from dense_visual_odometry_torch.parallel.batched import (  # noqa: F401
    BATCH_AXIS,
    batched_track_pair,
    make_batched_tracker,
    make_mesh,
    pad_batch_to_devices,
    shard_batch,
    stack_frame_data,
)
