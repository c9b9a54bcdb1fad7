"""Trajectory and report files.

Counterpart of ``dense_visual_odometry_tpu/io/trajectory.py``, writing the
same text: a TUM trajectory file (``# timestamp tx ty tz qx qy qz qw``,
camera-to-world) that TUM's evaluation tools read, and a JSON run report
with per-frame poses, transforms, errors and a summary (ATE / RPE).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from dense_visual_odometry_torch.utils.lie import Pose


def save_tum_trajectory(path, timestamps: Sequence[float], poses: Sequence) -> Path:
    """Write camera-to-world poses as a TUM trajectory file."""
    path = Path(path)
    lines = ["# timestamp tx ty tz qx qy qz qw"]
    for ts, pose in zip(timestamps, poses):
        if not isinstance(pose, Pose):
            pose = Pose.from_matrix(pose)
        tx, ty, tz, qx, qy, qz, qw = pose.to_tum()
        lines.append(
            f"{ts:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}"
        )
    path.write_text("\n".join(lines) + "\n")
    return path


def load_tum_trajectory(path):
    """-> (timestamps (N,), poses (N, 4, 4)) from a TUM trajectory file."""
    timestamps, poses = [], []
    with Path(path).open("r") as fp:
        for line in fp:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            timestamps.append(vals[0])
            tx, ty, tz, qx, qy, qz, qw = vals[1:8]
            poses.append(Pose.from_tum(tx, ty, tz, qx, qy, qz, qw).matrix.numpy())
    return np.asarray(timestamps), np.stack(poses) if poses else np.zeros((0, 4, 4))


def save_report(
    path,
    *,
    sequence_info: dict,
    timestamps: Sequence[float],
    estimated_poses: Sequence,
    transforms: Sequence,
    gt_poses: Optional[np.ndarray] = None,
    per_frame: Optional[List[dict]] = None,
    summary: Optional[dict] = None,
) -> Path:
    """JSON run report in the spirit of the reference's (test_dvo.py:327-334),
    with added summary metrics (ATE/RPE — the reference deferred those to
    external TUM tooling)."""
    path = Path(path)

    def tolist(mats):
        return [np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m, dtype=float).tolist()
                for m in mats]

    report = {
        "sequence": sequence_info,
        "timestamps": [float(t) for t in timestamps],
        "estimated_poses": tolist([p.matrix if isinstance(p, Pose) else p for p in estimated_poses]),
        "transformations": tolist([t.matrix if isinstance(t, Pose) else t for t in transforms]),
    }
    if gt_poses is not None:
        report["ground_truth_poses"] = tolist(gt_poses)
    if per_frame is not None:
        report["per_frame"] = per_frame
    if summary is not None:
        report["summary"] = summary
    path.write_text(json.dumps(report, indent=1))
    return path
