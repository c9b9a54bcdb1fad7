"""Lie-group utilities: SO(3)/SE(3) maps and a host-level ``Pose`` wrapper."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dense_visual_odometry_torch.utils.lie import se3, so3  # noqa: F401


class Pose(NamedTuple):
    """An SE(3) element stored as a (4, 4) float32 tensor."""

    matrix: torch.Tensor

    @classmethod
    def identity(cls, device=None) -> "Pose":
        return cls(torch.eye(4, dtype=torch.float32, device=device))

    @classmethod
    def from_xi(cls, xi) -> "Pose":
        """From a 6-vector twist (upsilon, phi)."""
        return cls(se3.exp(torch.as_tensor(xi, dtype=torch.float32).reshape(6)))

    @classmethod
    def from_matrix(cls, m) -> "Pose":
        return cls(torch.as_tensor(m, dtype=torch.float32).reshape(4, 4))

    @classmethod
    def from_rt(cls, rot, t) -> "Pose":
        return cls(
            se3.from_rt(
                torch.as_tensor(rot, dtype=torch.float32),
                torch.as_tensor(t, dtype=torch.float32),
            )
        )

    @classmethod
    def from_tum(cls, tx, ty, tz, qx, qy, qz, qw) -> "Pose":
        """From the TUM trajectory layout: translation + xyzw quaternion."""
        quat = torch.tensor([qw, qx, qy, qz], dtype=torch.float32)
        t = torch.tensor([tx, ty, tz], dtype=torch.float32)
        return cls(se3.from_quat_t(quat, t))

    def log(self) -> torch.Tensor:
        return se3.log(self.matrix)

    def inverse(self) -> "Pose":
        return Pose(se3.inverse(self.matrix))

    def __mul__(self, other: "Pose") -> "Pose":
        return Pose(se3.compose(self.matrix, other.matrix))

    @property
    def rotation(self) -> torch.Tensor:
        return self.matrix[..., :3, :3]

    @property
    def translation(self) -> torch.Tensor:
        return self.matrix[..., :3, 3]

    def to_tum(self) -> tuple:
        """-> (tx, ty, tz, qx, qy, qz, qw) floats for TUM trajectory files."""
        quat, t = se3.to_quat_t(self.matrix)
        quat = quat.detach().cpu().tolist()
        t = t.detach().cpu().tolist()
        return (t[0], t[1], t[2], quat[1], quat[2], quat[3], quat[0])

    def allclose(self, other: "Pose", atol: float = 1e-5) -> bool:
        rel = se3.log(se3.compose(se3.inverse(self.matrix), other.matrix))
        return bool(torch.all(torch.abs(rel) <= atol))


__all__ = ["so3", "se3", "Pose"]
