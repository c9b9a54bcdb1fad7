"""Pinhole RGB-D camera model.

Same schema and per-level convention as ``dense_visual_odometry_tpu/camera.py``:
YAML keys ``intrinsics`` (3x3 nested list) and ``depth_scale`` (the
reference's ``distorssion_*`` keys are read by name and ignored), and the
level-``l`` intrinsics ``K_l = S_l @ K`` with ``S_l = [[2^-l, 0,
2^(-l-1) - 0.5], [0, 2^-l, 2^(-l-1) - 0.5], [0, 0, 1]]``, which maps
full-resolution pixel centres onto the grid that keeps even rows/columns.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

INTRINSICS_KEY = "intrinsics"
DEPTH_SCALE_KEY = "depth_scale"
DISTORTION_COEFFS_KEY = "distorssion_coefficients"  # reference spelling
DISTORTION_MODEL_KEY = "distorssion_model"


class CameraModel(NamedTuple):
    """3x3 float32 intrinsics (a CPU tensor) + depth scale (DN -> meters)."""

    intrinsics: torch.Tensor
    depth_scale: float

    @classmethod
    def create(cls, intrinsics, depth_scale: float) -> "CameraModel":
        intrinsics = torch.as_tensor(
            np.asarray(intrinsics, dtype=np.float32)
        ).clone()
        if tuple(intrinsics.shape) not in ((3, 3), (3, 4)):
            raise ValueError(
                f"expected 3x3 intrinsics, got {tuple(intrinsics.shape)}"
            )
        if intrinsics.shape == (3, 4):
            intrinsics = intrinsics[:, :3].contiguous()
        if depth_scale < 0:
            raise ValueError("depth_scale must be non-negative")
        return cls(intrinsics=intrinsics, depth_scale=float(depth_scale))

    @classmethod
    def from_yaml(cls, filepath) -> "CameraModel":
        """Load from a camera-intrinsics YAML file."""
        import yaml  # optional dependency: only this loader needs it

        filepath = Path(filepath)
        if not filepath.exists():
            raise FileNotFoundError(f"camera intrinsics file not found: {filepath}")
        with filepath.open("r") as fp:
            data = yaml.safe_load(fp)
        try:
            intrinsics = np.asarray(data[INTRINSICS_KEY], dtype=np.float32)
            depth_scale = float(data[DEPTH_SCALE_KEY])
        except KeyError as exc:
            raise KeyError(f"missing key in camera YAML {filepath}: {exc}") from exc
        return cls.create(intrinsics, depth_scale)

    def level_scale_matrix(self, level: int) -> torch.Tensor:
        if level < 0:
            raise ValueError(f"level must be >= 0, got {level}")
        inv = 2.0 ** (-level)
        off = 2.0 ** (-level - 1) - 0.5
        return torch.tensor(
            [[inv, 0.0, off], [0.0, inv, off], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
            device=self.intrinsics.device,
        )

    def at(self, level: int) -> torch.Tensor:
        """Intrinsics for pyramid level ``level`` (0 = full resolution)."""
        if level == 0:
            return self.intrinsics
        return self.level_scale_matrix(level) @ self.intrinsics
