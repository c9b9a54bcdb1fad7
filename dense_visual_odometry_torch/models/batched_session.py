"""Batched multi-stream odometry: B independent cameras tracked in lockstep.

Counterpart of ``dense_visual_odometry_tpu/models/batched_session.py``
(BASELINE.json config 3, "batched multi-pair tracking"): each step
preprocesses B frames, tracks them against each stream's previous frame in
one batched solve, and commits per stream.  A stream whose solve fails, or
whose frame has fewer than 16 valid depth pixels, keeps its pose and
reference frame while the others advance; :meth:`BatchedOdometrySession.reset_stream`
re-seeds one stream without touching the rest.  The first step of a stream
tracks against zeroed pyramids, as the single-stream session does, and is
committed as the origin.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.models.robust import (
    FrameData,
    TrackResult,
    as_device_tensor,
    preprocess_frame,
    resolve_device,
    track_pair,
)
from dense_visual_odometry_torch.utils.lie import se3
from dense_visual_odometry_torch.utils.profiling import trace_span


class BatchedSessionState(NamedTuple):
    """Per-stream state on the session's device; every leaf leads with B."""

    pose: torch.Tensor  # (B, 4, 4) camera-to-world
    last_transform: torch.Tensor  # (B, 4, 4) last accepted frame-to-frame motion
    prev: FrameData  # previous frames' pyramids, (B, H, W) per level
    initialized: torch.Tensor  # (B,) bool


class BatchedStepOutput(NamedTuple):
    pose: torch.Tensor  # (B, 4, 4)
    transform: torch.Tensor  # (B, 4, 4), identity on a stream's first frame
    success: torch.Tensor  # (B,) bool
    result: TrackResult


def batched_session_step(
    state: BatchedSessionState,
    images,
    depths_raw,
    camera: CameraModel,
    cfg: RobustDVOConfig,
) -> Tuple[BatchedSessionState, BatchedStepOutput]:
    """Advance all B streams by one frame on the state's device.

    images: (B, H, W, 3) RGB or (B, H, W) gray; depths_raw: (B, H, W) raw
    depth DN.
    """
    dev = state.pose.device
    curr = preprocess_frame(
        images, depths_raw, camera, levels=cfg.levels,
        max_distance=cfg.max_distance, quantize=cfg.quantize_intensity, device=dev,
    )
    batch = state.pose.shape[0]
    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(batch, 4, 4)
    init = state.last_transform if cfg.constant_velocity_init else eye
    result = track_pair(
        state.prev, curr, camera, cfg,
        init_guess=init, last_transform=state.last_transform,
    )
    with trace_span("session.commit"):
        curr_usable = torch.sum(curr.depth_m[0] > 0.0, dim=(-2, -1)) >= 16
        is_first = ~state.initialized
        transform = torch.where(is_first[:, None, None], eye, result.transform)
        success = (is_first | result.success) & curr_usable
        sel = success[:, None, None]
        new_pose = torch.where(sel, state.pose @ se3.inverse(transform), state.pose)

        def commit(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
            return torch.where(success.reshape((batch,) + (1,) * (new.ndim - 1)), new, old)

        new_state = BatchedSessionState(
            pose=new_pose,
            last_transform=torch.where(sel, transform, state.last_transform),
            prev=FrameData(
                gray=tuple(commit(n, o) for n, o in zip(curr.gray, state.prev.gray)),
                depth_m=tuple(commit(n, o) for n, o in zip(curr.depth_m, state.prev.depth_m)),
            ),
            initialized=state.initialized | curr_usable,
        )
    return new_state, BatchedStepOutput(
        pose=new_pose, transform=transform, success=success, result=result
    )


def init_batched_state(
    batch: int, height: int, width: int, levels: int, init_poses=None, device=None
) -> BatchedSessionState:
    """Fresh state for ``batch`` streams with zeroed previous-frame pyramids
    on ``device`` (None = the GPU)."""
    dev = resolve_device(device)

    def zeros_pyramid():
        out, h, w = [], height, width
        for _ in range(levels):
            out.append(torch.zeros((batch, h, w), dtype=torch.float32, device=dev))
            h, w = -(-h // 2), -(-w // 2)
        return tuple(out)

    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(batch, 4, 4)
    poses = (
        eye.clone() if init_poses is None
        else as_device_tensor(np.asarray(init_poses, np.float32), dev)
    )
    return BatchedSessionState(
        pose=poses,
        last_transform=eye.clone(),
        prev=FrameData(gray=zeros_pyramid(), depth_m=zeros_pyramid()),
        initialized=torch.zeros((batch,), dtype=torch.bool, device=dev),
    )


class BatchedOdometrySession:
    """Feed B frames at a time, read B poses.  Runs on the GPU unless
    ``device`` says otherwise; without a GPU the default raises.

    >>> sessions = BatchedOdometrySession(camera, cfg, batch=32)
    >>> poses = sessions.step(rgb_batch, depth_batch)   # (32, 4, 4)
    """

    def __init__(
        self,
        camera: CameraModel,
        config: Optional[RobustDVOConfig] = None,
        batch: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.camera = camera
        self.config = config or RobustDVOConfig(levels=4, use_weighter=True)
        self._batch = batch
        self._state: Optional[BatchedSessionState] = None
        self.last_output: Optional[BatchedStepOutput] = None

    def step(self, images, depths) -> torch.Tensor:
        """Advance all streams; returns (B, 4, 4) camera-to-world poses."""
        shape = depths.shape if isinstance(depths, torch.Tensor) else np.shape(depths)
        with trace_span("session.step", streams=shape[0]):
            if self._state is None:
                b, h, w = shape[0], shape[-2], shape[-1]
                if self._batch is not None and b != self._batch:
                    raise ValueError(f"expected batch {self._batch}, got {b}")
                self._state = init_batched_state(b, h, w, self.config.levels, device=self.device)
            self._state, out = batched_session_step(
                self._state, images, depths, self.camera, self.config
            )
        self.last_output = out
        return out.pose

    def reset_stream(self, index: int, init_pose=None) -> None:
        """Re-seed one stream: its pose to the identity (or ``init_pose``),
        its motion to the identity, and its next frame becomes its origin."""
        if self._state is None:
            return
        s = self._state
        pose, last, initialized = s.pose.clone(), s.last_transform.clone(), s.initialized.clone()
        pose[index] = (
            torch.eye(4, dtype=torch.float32, device=self.device)
            if init_pose is None
            else as_device_tensor(np.asarray(init_pose, np.float32), self.device)
        )
        last[index] = torch.eye(4, dtype=torch.float32, device=self.device)
        initialized[index] = False
        self._state = s._replace(pose=pose, last_transform=last, initialized=initialized)

    @property
    def poses(self) -> Optional[torch.Tensor]:
        return None if self._state is None else self._state.pose
