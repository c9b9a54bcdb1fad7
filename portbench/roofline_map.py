"""The yardstick of the mapping layer's roofline share.

A TSDF fusion pass reads and writes the three float32 fields (tsdf,
weight, gray) of every voxel it visits and reads the frame it fuses (depth
and gray, float32): ``fuse_bytes``.  ``fuse_bound_ms`` is that traffic at
the memory's peak (``roofline.PEAK_BYTES_PER_S``, one H100 SXM); a dense
512^3 pass of a 640x480 frame moves 3.22 GB, 0.96 ms.  Its operations (a
few tens of FP32 a voxel) are far under the FP32 peak's share of that time.
"""

from __future__ import annotations

from portbench.roofline import PEAK_BYTES_PER_S

FIELDS = 3
FIELD_BYTES = 4
FRAME_BYTES_PER_PIXEL = 8  # depth and gray, float32


def fuse_bytes(voxels: int, frame_pixels: int, passes: int = 1) -> float:
    """Bytes that ``passes`` fusion passes over ``voxels`` voxels in all
    move at the least."""
    return float(voxels * FIELDS * FIELD_BYTES * 2 + passes * frame_pixels * FRAME_BYTES_PER_PIXEL)


def fuse_bound_ms(voxels: int, frame_pixels: int, passes: int = 1) -> float:
    return fuse_bytes(voxels, frame_pixels, passes) / PEAK_BYTES_PER_S * 1e3
