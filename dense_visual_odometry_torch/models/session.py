"""Streaming odometry session: the per-frame state machine around the tracker.

Counterpart of ``dense_visual_odometry_tpu/models/session.py``: the first
frame sets the origin; every later frame is tracked against the previous
one, the pose becomes ``pose_{t-1} @ transform^-1``, and a failed solve
(or a frame with fewer than 16 valid depth pixels) leaves the pose and the
reference frame untouched.  With ``constant_velocity_init`` each solve is
seeded with the last accepted frame-to-frame motion.  The state stays on
the session's device; pyramids are unbatched (H, W) per level and get a
batch of one for the tracker.
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
from dense_visual_odometry_torch.utils.lie import Pose, se3
from dense_visual_odometry_torch.utils.profiling import trace_span


class SessionState(NamedTuple):
    pose: torch.Tensor  # (4, 4) camera-to-world
    last_transform: torch.Tensor  # (4, 4) last accepted frame-to-frame motion
    prev: FrameData  # previous frame's pyramids, (H, W) per level
    initialized: torch.Tensor  # bool scalar


class StepOutput(NamedTuple):
    pose: torch.Tensor
    transform: torch.Tensor  # identity on the first frame
    success: torch.Tensor
    result: TrackResult  # batch of one


def session_step(
    state: SessionState,
    image,
    depth_raw,
    camera: CameraModel,
    init_guess: torch.Tensor,
    cfg: RobustDVOConfig,
    use_cv_guess: bool = False,
) -> Tuple[SessionState, StepOutput]:
    """One tracking step on the state's device.  ``use_cv_guess`` seeds
    the solve with ``state.last_transform`` instead of ``init_guess``."""
    dev = state.pose.device
    curr = preprocess_frame(
        image, depth_raw, camera, levels=cfg.levels,
        max_distance=cfg.max_distance, quantize=cfg.quantize_intensity,
        device=dev,
    )

    def batch1(frame: FrameData) -> FrameData:
        return FrameData(
            gray=tuple(g[None] for g in frame.gray),
            depth_m=tuple(d[None] for d in frame.depth_m),
        )

    result = track_pair(
        batch1(state.prev), batch1(curr), camera, cfg,
        init_guess=state.last_transform if use_cv_guess else init_guess,
        last_transform=state.last_transform,
    )
    with trace_span("session.commit"):
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        # A frame with (almost) no valid depth may still track but must not
        # become the reference frame.
        curr_usable = torch.sum(curr.depth_m[0] > 0.0) >= 16
        is_first = ~state.initialized
        transform = torch.where(is_first, eye, result.transform[0])
        success = (is_first | result.success[0]) & curr_usable
        new_pose = torch.where(success, state.pose @ se3.inverse(transform), state.pose)
        new_prev = FrameData(
            gray=tuple(torch.where(success, n, o) for n, o in zip(curr.gray, state.prev.gray)),
            depth_m=tuple(
                torch.where(success, n, o) for n, o in zip(curr.depth_m, state.prev.depth_m)
            ),
        )
        new_state = SessionState(
            pose=new_pose,
            last_transform=torch.where(success, transform, state.last_transform),
            prev=new_prev,
            initialized=state.initialized | curr_usable,
        )
    return new_state, StepOutput(
        pose=new_pose, transform=transform, success=success, result=result
    )


def init_state(height: int, width: int, levels: int, init_pose=None, device=None) -> SessionState:
    """Fresh state with zeroed previous-frame pyramids on ``device``."""
    dev = resolve_device(device)

    def zeros_pyramid():
        out, h, w = [], height, width
        for _ in range(levels):
            out.append(torch.zeros((h, w), dtype=torch.float32, device=dev))
            h, w = -(-h // 2), -(-w // 2)
        return tuple(out)

    pose = (
        torch.eye(4, dtype=torch.float32, device=dev)
        if init_pose is None
        else as_device_tensor(np.asarray(init_pose, np.float32), dev)
    )
    return SessionState(
        pose=pose,
        last_transform=torch.eye(4, dtype=torch.float32, device=dev),
        prev=FrameData(gray=zeros_pyramid(), depth_m=zeros_pyramid()),
        initialized=torch.tensor(False, device=dev),
    )


def session_state_from_numpy(state, device) -> SessionState:
    """A ``SessionState`` of arrays (e.g. the JAX package's, as numpy) ->
    this package's tensors on ``device``."""
    dev = torch.device(device)

    def conv(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype=dtype), device=dev)

    return SessionState(
        pose=conv(state.pose),
        last_transform=conv(state.last_transform),
        prev=FrameData(
            gray=tuple(conv(g) for g in state.prev.gray),
            depth_m=tuple(conv(d) for d in state.prev.depth_m),
        ),
        initialized=conv(state.initialized, np.bool_),
    )


class OdometrySession:
    """Feed frames, read poses.  Runs on the GPU unless ``device`` says
    otherwise; without a GPU the default raises.

    >>> session = OdometrySession(camera, RobustDVOConfig.from_json(path))
    >>> for rgb, depth in frames:
    ...     pose = session.step(rgb, depth)
    """

    def __init__(
        self,
        camera: CameraModel,
        config: Optional[RobustDVOConfig] = None,
        init_pose=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.camera = camera
        self.config = config or RobustDVOConfig()
        self._init_pose = init_pose
        self._state: Optional[SessionState] = None
        self.last_output: Optional[StepOutput] = None

    def reset(self) -> None:
        self._state = None
        self.last_output = None

    def step(self, image, depth, init_guess=None) -> Pose:
        """Track one frame; returns the camera-to-world pose.  Diagnostics
        of the step are in :attr:`last_output`."""
        with trace_span("session.step", streams=1):
            if self._state is None:
                shape = depth.shape if isinstance(depth, torch.Tensor) else np.shape(depth)
                h, w = shape[-2:]
                self._state = init_state(
                    h, w, self.config.levels, self._init_pose, self.device
                )
            use_cv = init_guess is None and self.config.constant_velocity_init
            guess = (
                torch.eye(4, dtype=torch.float32, device=self.device)
                if init_guess is None
                else as_device_tensor(np.asarray(init_guess, np.float32), self.device)
            )
            self._state, out = session_step(
                self._state, image, depth, self.camera, guess, self.config,
                use_cv_guess=use_cv,
            )
        self.last_output = out
        return Pose(out.pose)

    @property
    def current_pose(self) -> Pose:
        if self._state is None:
            if self._init_pose is None:
                return Pose(torch.eye(4, dtype=torch.float32, device=self.device))
            return Pose(as_device_tensor(np.asarray(self._init_pose, np.float32), self.device))
        return Pose(self._state.pose)
