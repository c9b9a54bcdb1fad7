"""Data in and out: RGB-D sequences (TUM directories, the bundled set),
PNG files, trajectories and reports, odometry and SLAM checkpoints, synthetic
data."""

from dense_visual_odometry_torch.io.datasets import (  # noqa: F401
    RGBDSequence,
    load_bundled_sequence,
    load_tum_sequence,
    pyr_down_sequence,
)
from dense_visual_odometry_torch.io import checkpoint, png, synthetic, trajectory  # noqa: F401
