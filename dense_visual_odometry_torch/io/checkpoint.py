"""Checkpoint and resume of odometry sessions and trajectories.

The session half of ``dense_visual_odometry_tpu/io/checkpoint.py``, in the
same ``.npz`` format (``FORMAT_VERSION`` 1, the same keys): a session saved
by either package resumes in the other.  :func:`save_session` writes an
:class:`~dense_visual_odometry_torch.models.session.OdometrySession`'s
state (pose, last motion, the previous frame's pyramids), and
:func:`load_session` restores it onto the session's device;
:func:`save_trajectory_state` / :func:`load_trajectory_state` keep a
trajectory so far and its frame cursor.  The SLAM half (keyframe graphs)
waits for the port's SLAM back end.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dense_visual_odometry_torch.models.robust import FrameData
from dense_visual_odometry_torch.models.session import (
    OdometrySession,
    SessionState,
    session_state_from_numpy,
)

FORMAT_VERSION = 1


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_session(path, session: OdometrySession) -> Path:
    """Serialize an :class:`OdometrySession`'s state to ``path``."""
    path = Path(path)
    state = session._state
    if state is None:
        raise ValueError("session has no state yet (no frames processed)")
    arrays = {
        "version": np.asarray(FORMAT_VERSION),
        "pose": _np(state.pose),
        "last_transform": _np(state.last_transform),
        "initialized": _np(state.initialized),
        "levels": np.asarray(len(state.prev.gray)),
        "intrinsics": _np(session.camera.intrinsics),
        "depth_scale": np.asarray(session.camera.depth_scale),
    }
    _frame_to_arrays("", state.prev, arrays)
    with path.open("wb") as fp:
        np.savez_compressed(fp, **arrays)
    return path


def load_session(path, session: OdometrySession) -> OdometrySession:
    """Restore the state saved by :func:`save_session` (of either package)
    into ``session``, on its device.  The session's config must have the
    same pyramid depth; image shapes come from the file."""
    path = Path(path)
    with np.load(path) as data:
        version = int(data["version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        levels = int(data["levels"])
        if levels != session.config.levels:
            raise ValueError(
                f"checkpoint has {levels} pyramid levels, session config "
                f"expects {session.config.levels}"
            )
        state = SessionState(
            pose=data["pose"],
            last_transform=data["last_transform"],
            prev=_frame_from_arrays("", levels, data),
            initialized=data["initialized"],
        )
    session._state = session_state_from_numpy(state, session.device)
    return session


def _key(prefix: str, kind: str, level: int) -> str:
    """The JAX package's array names: ``gray_0`` for a session's previous
    frame, ``<prefix>_gray_0`` for a named frame."""
    return f"{prefix}_{kind}_{level}" if prefix else f"{kind}_{level}"


def _frame_to_arrays(prefix: str, fd: FrameData, arrays: dict) -> None:
    """Add a frame's pyramids to ``arrays`` under :func:`_key`'s names."""
    for lv, (g, d) in enumerate(zip(fd.gray, fd.depth_m)):
        arrays[_key(prefix, "gray", lv)] = _np(g)
        arrays[_key(prefix, "depth", lv)] = _np(d)


def _frame_from_arrays(prefix: str, levels: int, data) -> FrameData:
    """The numpy pyramids :func:`_frame_to_arrays` wrote."""
    return FrameData(
        gray=tuple(np.asarray(data[_key(prefix, "gray", lv)]) for lv in range(levels)),
        depth_m=tuple(np.asarray(data[_key(prefix, "depth", lv)]) for lv in range(levels)),
    )


def save_trajectory_state(
    path,
    poses: np.ndarray,
    timestamps: Optional[np.ndarray] = None,
    frame_index: int = 0,
) -> Path:
    """Lightweight mid-run trajectory snapshot (poses so far + cursor)."""
    path = Path(path)
    arrays = {
        "version": np.asarray(FORMAT_VERSION),
        "poses": _np(poses),
        "frame_index": np.asarray(frame_index),
    }
    if timestamps is not None:
        arrays["timestamps"] = np.asarray(timestamps)
    with path.open("wb") as fp:
        np.savez_compressed(fp, **arrays)
    return path


def load_trajectory_state(path):
    """-> dict with poses / frame_index / timestamps (or None)."""
    with np.load(Path(path)) as data:
        return {
            "poses": data["poses"],
            "frame_index": int(data["frame_index"]),
            "timestamps": data["timestamps"] if "timestamps" in data else None,
        }
