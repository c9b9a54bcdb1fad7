"""Checkpoint and resume of odometry and SLAM sessions and trajectories.

Counterpart of ``dense_visual_odometry_tpu/io/checkpoint.py``, in the same
``.npz`` format (``FORMAT_VERSION`` 1, the same keys): a checkpoint saved by
either package resumes in the other.  :func:`save_session` writes an
:class:`~dense_visual_odometry_torch.models.session.OdometrySession`'s
state (pose, last motion, the previous frame's pyramids), and
:func:`load_session` restores it onto the session's device;
:func:`save_slam_session` / :func:`load_slam_session` do the same for a
:class:`~dense_visual_odometry_torch.models.slam.SlamSession` (keyframe
graph, edges, loop closures, relocalizations, per-frame bookkeeping and
every retained keyframe's pyramids);
:func:`save_trajectory_state` / :func:`load_trajectory_state` keep a
trajectory so far and its frame cursor.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dense_visual_odometry_torch.models.robust import FrameData, frame_data_from_numpy
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


def save_slam_session(path, slam) -> Path:
    """Serialize a :class:`~dense_visual_odometry_torch.models.slam.SlamSession`:
    keyframe poses and indices, the full edge set (measurements and
    information), loop closures, relocalizations, per-frame bookkeeping,
    and every retained keyframe's pyramids (evicted entries stay evicted)."""
    path = Path(path)
    if slam._keyframe is None:
        raise ValueError("slam session has no keyframes yet")
    levels = len(slam._keyframe.gray)
    n_edges = len(slam._edges_i)
    arrays = {
        "version": np.asarray(FORMAT_VERSION),
        "kind": np.asarray("slam"),
        "levels": np.asarray(levels),
        "frame_idx": np.asarray(slam._frame_idx),
        "kf_valid_count": np.asarray(slam._kf_valid_count),
        "rel_to_kf": np.asarray(slam._rel_to_kf),
        "last_inc": np.asarray(slam._last_inc),
        "keyframe_poses": np.stack(slam.keyframe_poses),
        "keyframe_indices": np.asarray(slam.keyframe_indices, np.int64),
        "edges_i": np.asarray(slam._edges_i, np.int64),
        "edges_j": np.asarray(slam._edges_j, np.int64),
        "edges_meas": (
            np.stack(slam._edges_meas) if n_edges else np.zeros((0, 4, 4))
        ),
        "edges_info": (
            np.stack(slam._edges_info) if n_edges else np.zeros((0, 6, 6))
        ),
        "loop_closures": np.asarray(slam.loop_closures, np.float64).reshape(-1, 3),
        "frame_poses": (
            np.stack(slam.frame_poses) if slam.frame_poses else np.zeros((0, 4, 4))
        ),
        "frame_kf": np.asarray(slam._frame_kf, np.int64),
        "frame_rel": (
            np.stack(slam._frame_rel) if slam._frame_rel else np.zeros((0, 4, 4))
        ),
        "kf_retained": np.asarray([fd is not None for fd in slam._kf_frames], bool),
        "active_kf": np.asarray(slam._active_kf),
        "lost_count": np.asarray(slam._lost_count),
        "relocalizations": np.asarray(slam.relocalizations, np.int64).reshape(-1, 2),
    }
    for k, fd in enumerate(slam._kf_frames):
        if fd is not None:
            _frame_to_arrays(f"kf{k}", fd, arrays)
    with path.open("wb") as fp:
        np.savez_compressed(fp, **arrays)
    return path


def load_slam_session(path, slam):
    """Restore the state saved by :func:`save_slam_session` (of either
    package) into ``slam``, a fresh ``SlamSession`` with the same config
    and policy, on its device.  Place-recognition descriptors are
    recomputed from the retained pyramids (an evicted keyframe gets a zero
    descriptor); the previous frame of two-step tracking is not saved, so
    a resumed two-step session tracks its first frame directly."""
    from dense_visual_odometry_torch.models.slam import _frame_descriptor

    path = Path(path)
    with np.load(path) as data:
        version = int(data["version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        if str(data["kind"]) != "slam":
            raise ValueError("not a SLAM checkpoint")
        levels = int(data["levels"])
        if levels != slam.config.levels:
            raise ValueError(
                f"checkpoint has {levels} pyramid levels, session config "
                f"expects {slam.config.levels}"
            )
        slam._frame_idx = int(data["frame_idx"])
        slam._kf_valid_count = float(data["kf_valid_count"])
        slam._rel_to_kf = np.asarray(data["rel_to_kf"])
        slam._last_inc = np.asarray(data["last_inc"])
        slam.keyframe_poses = list(np.asarray(data["keyframe_poses"]))
        slam.keyframe_indices = [int(i) for i in data["keyframe_indices"]]
        slam._edges_i = [int(i) for i in data["edges_i"]]
        slam._edges_j = [int(j) for j in data["edges_j"]]
        slam._edges_meas = list(np.asarray(data["edges_meas"]))
        slam._edges_info = list(np.asarray(data["edges_info"]))
        slam.loop_closures = [
            (int(a), int(b), float(e)) for a, b, e in data["loop_closures"]
        ]
        slam.frame_poses = list(np.asarray(data["frame_poses"]))
        slam._frame_kf = [int(k) for k in data["frame_kf"]]
        slam._frame_rel = list(np.asarray(data["frame_rel"]))
        retained = np.asarray(data["kf_retained"])
        slam._kf_frames = [
            frame_data_from_numpy(_frame_from_arrays(f"kf{k}", levels, data), slam.device)
            if keep else None
            for k, keep in enumerate(retained)
        ]
        # Recovery state (absent in checkpoints from before relocalization).
        if "active_kf" in data.files:
            slam._active_kf = int(data["active_kf"])
            slam._lost_count = int(data["lost_count"])
            slam.relocalizations = [
                (int(f), int(j)) for f, j in data["relocalizations"]
            ]
        else:
            slam._active_kf = len(slam._kf_frames) - 1
            slam._lost_count = 0
            slam.relocalizations = []
    slam._keyframe = slam._kf_frames[slam._active_kf] if slam._kf_frames else None
    slam._kf_desc = [
        np.zeros(96) if fd is None
        else _frame_descriptor(fd.gray[-1]).detach().cpu().numpy()
        for fd in slam._kf_frames
    ]
    slam._prev_fd = None
    return slam


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
