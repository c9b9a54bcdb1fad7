"""Frame-to-model tracking: align each frame against the fused TSDF.

Counterpart of ``dense_visual_odometry_tpu/models/frame_to_model.py``.  The
tracking reference is a virtual keyframe rendered from the volume (depth
averaged over every view fused so far, intensity from the voxels' running
gray), tracked with the same solver as every other tracker here:

- keyframe mode (:meth:`FrameToModelTracker.step`): the virtual keyframe is
  re-rendered (the splat raycast by default) when the estimate leaves the
  policy's translation / rotation envelope, and each frame is tracked
  against the last render;
- KinectFusion mode (``render_every_frame``): each frame renders the model
  at the previous pose (the march), tracks one frame's motion against it
  and is fused at the refined pose on success.  The policy's
  ``raycast="volume"`` marches only each ray's stretch inside the volume,
  every :data:`~dense_visual_odometry_torch.models.tsdf.VOLUME_MARCH_STEP`
  truncations (KinFu's raycast).

A step reads one packed float32 vector back to the host (besides the
tracker's own reads inside its loops); in KinectFusion mode the frame is
fused only after that read says so, so that a failed or skipped frame
leaves the volume as it was.  The step's render (level 0) stays on the
tracker as :attr:`FrameToModelTracker.last_render`.

With the tracer on (``utils/profiling.py``) a step records ``session.step``
(``streams=1``) around ``map.render`` (the raycast into the keyframe's
pyramids), ``map.track`` (the frame's preprocessing and the solve, the
tracker's ``track.*`` spans inside), ``sync.map`` (the pack's read) and
``map.fuse``, and counts ``map.fused``, ``map.fused_kernel`` (the fusions
that launched the fusion kernel), ``map.failed``, ``map.march_steps`` (the
volume march's steps) and ``map.voxels_fused`` (the voxels a fusion
visits).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.models.brick_tsdf import (
    BrickTSDFConfig,
    integrate_brick,
    make_brick_volume,
    raycast_view_march_brick,
)
from dense_visual_odometry_torch.models.robust import FrameData, resolve_device, track_pair
from dense_visual_odometry_torch.models.slam import _preprocess
from dense_visual_odometry_torch.models.tsdf import (
    VOLUME_MARCH_STEP,
    TSDFConfig,
    integrate,
    make_volume,
    raycast_view,
    raycast_view_march,
    raycast_view_march_volume,
    volume_march_steps,
)
from dense_visual_odometry_torch.ops import pyramid as pyr_ops
from dense_visual_odometry_torch.ops.cuda import tsdf as tsdf_kernel
from dense_visual_odometry_torch.utils.lie import Pose, se3
from dense_visual_odometry_torch.utils.profiling import count, trace_span


def _vol_integrate(volume, depth_m, gray, intrinsics, pose, tsdf_cfg):
    """Dense or brick fusion, by the configuration's type (in place)."""
    if isinstance(tsdf_cfg, BrickTSDFConfig):
        return integrate_brick(volume, depth_m, gray, intrinsics, pose, tsdf_cfg)
    return integrate(volume, depth_m, gray, intrinsics, pose, tsdf_cfg)


def _vol_render(volume, intrinsics, pose, tsdf_cfg, shape, min_weight, max_depth, raycast,
                march=None):
    """The virtual view's (depth, gray).  The brick volume has the march
    only (a splat would project every pool voxel).  ``march``, the volume
    march's (step, steps), is given where the policy's raycast is
    "volume"."""
    if isinstance(tsdf_cfg, BrickTSDFConfig):
        return raycast_view_march_brick(volume, intrinsics, pose, tsdf_cfg, shape,
                                        min_weight=min_weight, max_depth=max_depth)
    if march is not None:
        step, n_steps = march
        return raycast_view_march_volume(volume, intrinsics, pose, tsdf_cfg, shape, n_steps,
                                         step, min_weight=min_weight, max_depth=max_depth)
    render = raycast_view if raycast == "splat" else raycast_view_march
    return render(volume, intrinsics, pose, tsdf_cfg, shape,
                  min_weight=min_weight, max_depth=max_depth)


@dataclasses.dataclass(frozen=True)
class ModelTrackerPolicy:
    """When to re-render the virtual keyframe, and map hygiene."""

    max_translation: float = 0.10  # meters vs the virtual keyframe
    max_rotation: float = 0.10  # radians vs the virtual keyframe
    # Skip fusing frames whose solve failed, so that a wrong alignment does
    # not poison every later render.
    integrate_on_failure: bool = False
    min_weight: float = 1.0  # raycast surface-confidence gate
    max_render_depth: float = 10.0
    # Render the model at the previous pose every frame and track against
    # it (the KinectFusion loop): the warp is then always one frame's
    # motion, so the render's error at oblique incidence, which grows with
    # the viewpoint gap, stops feeding into the template.
    render_every_frame: bool = False
    # "splat" (one scatter pass, about half a voxel of per-pixel jitter),
    # "march" (per-ray marching with trilinear refinement, 96 fixed steps
    # from min_depth to max_render_depth; the choice for render_every_frame,
    # where splat jitter random-walks into the track) or "volume" (the
    # march over each ray's stretch inside the dense volume only, every
    # VOLUME_MARCH_STEP truncations, so that a thin band is not stepped over).
    raycast: str = "splat"


def _render_keyframe(volume, intrinsics, pose, cfg: RobustDVOConfig, tsdf_cfg, shape,
                     min_weight: float, max_depth: float, raycast: str = "splat",
                     march=None) -> FrameData:
    """Raycast the volume into a virtual keyframe's pyramids."""
    depth, gray = _vol_render(volume, intrinsics, pose, tsdf_cfg, shape, min_weight,
                              max_depth, raycast, march)
    return FrameData(gray=pyr_ops.build_pyramid(gray, cfg.levels),
                     depth_m=pyr_ops.build_pyramid(depth, cfg.levels))


def _batch1(frame: FrameData) -> FrameData:
    return FrameData(gray=tuple(g[None] for g in frame.gray),
                     depth_m=tuple(d[None] for d in frame.depth_m))


def _track_step(keyframe: FrameData, fd: FrameData, intrinsics: torch.Tensor,
                init_guess: torch.Tensor, cfg: RobustDVOConfig) -> torch.Tensor:
    """Frame-to-model solve -> [transform 16 | success 1 | se3.log 6]."""
    camera = CameraModel(intrinsics=intrinsics, depth_scale=1.0)
    result = track_pair(_batch1(keyframe), _batch1(fd), camera, cfg,
                        init_guess=init_guess, last_transform=init_guess)
    transform = result.transform[0]
    return torch.cat([transform.reshape(-1), result.success.to(torch.float32).reshape(1),
                      se3.log(transform).reshape(-1)])


def _kinfu_step(volume, pose_prev: torch.Tensor, image, depth, camera: CameraModel,
                init_inc: torch.Tensor, cfg: RobustDVOConfig, tsdf_cfg, shape,
                min_weight: float, max_depth: float, raycast: str = "march", march=None):
    """Render the model at ``pose_prev``, preprocess the frame, track it
    (one frame of motion) -> (frame, world pose, pack = [transform 16 |
    success 1 | world 16 | valid px 1], the render's pyramids).  The caller
    fuses the frame."""
    dev = pose_prev.device
    with trace_span("map.render"):
        kf = _render_keyframe(volume, camera.intrinsics.to(dev), pose_prev, cfg, tsdf_cfg,
                              shape, min_weight, max_depth, raycast, march)
    with trace_span("map.track"):
        fd = _preprocess(image, depth, camera, cfg, dev)
        result = track_pair(_batch1(kf), _batch1(fd), camera, cfg,
                            init_guess=init_inc, last_transform=init_inc)
        transform, success = result.transform[0], result.success[0]
        world = torch.where(success, pose_prev @ se3.inverse(transform), pose_prev)
        pack = torch.cat([transform.reshape(-1), success.to(torch.float32).reshape(1),
                          world.reshape(-1),
                          torch.sum(fd.depth_m[0] > 0.0, dtype=torch.float32).reshape(1)])
    return fd, world, pack, kf


class FrameToModelTracker:
    """Streaming frame-to-model odometry against a live TSDF, on the GPU
    unless ``device`` says otherwise.

    >>> tracker = FrameToModelTracker(camera, cfg, tsdf_cfg)
    >>> for rgb, depth in seq:
    ...     pose = tracker.step(rgb, depth)
    """

    def __init__(
        self,
        camera: CameraModel,
        config: Optional[RobustDVOConfig] = None,
        tsdf_config=None,
        policy: Optional[ModelTrackerPolicy] = None,
        every: int = 1,
        device=None,
    ):
        self.device = resolve_device(device)
        self.camera = camera
        self.config = config or RobustDVOConfig(levels=4, use_weighter=True)
        self.tsdf_config = tsdf_config or TSDFConfig()
        self.policy = policy or ModelTrackerPolicy()
        self.every = every
        self._intrinsics = camera.intrinsics.to(self.device, torch.float32)
        brick = isinstance(self.tsdf_config, BrickTSDFConfig)
        if brick and self.policy.raycast == "volume":
            raise ValueError("the volume march (raycast='volume') needs the dense volume")
        self.volume = (
            make_brick_volume(self.tsdf_config, self.device)
            if brick else make_volume(self.tsdf_config, self.device)
        )
        # The voxels one fusion visits: the active bricks, or the whole grid.
        self._voxels_fused = (self.tsdf_config.active_bricks * self.tsdf_config.brick_size ** 3
                              if brick else int(np.prod(self.tsdf_config.dims)))
        self._keyframe: Optional[FrameData] = None
        self._kf_pose = np.eye(4)
        self._rel_to_kf = np.eye(4)
        self._last_inc = np.eye(4)
        self.frame_poses: List[np.ndarray] = []
        self.renders = 0
        self.failures = 0
        self._frame_idx = 0
        self._shape: Optional[tuple] = None
        # The last step's level-0 render (depth, gray) that it tracked
        # against, its motion (previous camera -> current camera, the
        # identity on the first frame) and whether the solve succeeded.
        self.last_render: Optional[tuple] = None
        self.last_transform = np.eye(4)
        self.last_success = True

    def _tensor(self, m: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(m, np.float32), device=self.device)

    def _integrate(self, fd: FrameData, world: torch.Tensor) -> None:
        launches = tsdf_kernel.integrate_volume.launches
        with trace_span("map.fuse"):
            _vol_integrate(self.volume, fd.depth_m[0], fd.gray[0], self._intrinsics, world,
                           self.tsdf_config)
        count("map.fused")
        count("map.fused_kernel", tsdf_kernel.integrate_volume.launches - launches)
        count("map.voxels_fused", self._voxels_fused)

    def _march(self, world: np.ndarray):
        """The volume march's (step, steps) from ``world``, or None for
        the policy's other renders."""
        if self.policy.raycast != "volume":
            return None
        step = VOLUME_MARCH_STEP * self.tsdf_config.truncation
        n_steps = volume_march_steps(self.tsdf_config, world, step, self.policy.max_render_depth)
        count("map.march_steps", n_steps)
        return step, n_steps

    def _render(self, world: np.ndarray) -> None:
        with trace_span("map.render"):
            self._keyframe = _render_keyframe(
                self.volume, self._intrinsics, self._tensor(world), self.config,
                self.tsdf_config, self._shape, self.policy.min_weight,
                self.policy.max_render_depth, raycast=self.policy.raycast,
                march=self._march(world),
            )
        self._kf_pose = world.copy()
        self._rel_to_kf = np.eye(4)
        self.renders += 1

    def step(self, image, depth) -> Pose:
        """Process one frame; returns its world pose."""
        with trace_span("session.step", streams=1):
            if self.policy.render_every_frame and self._shape is not None:
                return self._step_kinfu(image, depth)
            return self._step_keyframe(image, depth)

    def _step_keyframe(self, image, depth) -> Pose:
        """The first frame, or one keyframe-mode step."""
        with trace_span("map.track"):
            fd = _preprocess(image, depth, self.camera, self.config, self.device)
        if self._keyframe is None:
            self._shape = tuple(fd.depth_m[0].shape)
            world = np.eye(4)
            self._integrate(fd, self._tensor(world))
            if not self.policy.render_every_frame:
                self._render(world)
            self._kf_pose = world.copy()
            self.frame_poses.append(world)
            self.last_transform, self.last_success = np.eye(4), True
            self._frame_idx += 1
            return Pose(self._tensor(world))

        self.last_render = (self._keyframe.depth_m[0], self._keyframe.gray[0])
        init = (self._last_inc @ np.linalg.inv(self._rel_to_kf)).astype(np.float32)
        with trace_span("map.track"):
            pack_d = _track_step(self._keyframe, fd, self._intrinsics, self._tensor(init),
                                 self.config)
        with trace_span("sync.map"):
            pack = pack_d.cpu().numpy().astype(np.float64)
        success = pack[16] > 0.5
        transform = pack[:16].reshape(4, 4)
        self.last_transform, self.last_success = transform, bool(success)
        if success:
            prev_rel = self._rel_to_kf
            rel = np.linalg.inv(transform)
            self._last_inc = np.linalg.inv(rel) @ prev_rel
            self._rel_to_kf = rel
        else:
            self.failures += 1
            count("map.failed")
        world = self._kf_pose @ self._rel_to_kf
        self.frame_poses.append(world)

        if (success or self.policy.integrate_on_failure) and self._frame_idx % self.every == 0:
            self._integrate(fd, self._tensor(world))

        xi = pack[17:23]
        if success and (np.linalg.norm(xi[:3]) > self.policy.max_translation
                        or np.linalg.norm(xi[3:]) > self.policy.max_rotation):
            self._render(world)
        self._frame_idx += 1
        return Pose(self._tensor(world))

    def _step_kinfu(self, image, depth) -> Pose:
        """One KinectFusion step: render at the previous pose, track, and
        fuse at the refined pose when the solve succeeded (and ``every``
        says so)."""
        fd, world_d, pack_d, kf = _kinfu_step(
            self.volume, self._tensor(self.frame_poses[-1]), image, depth, self.camera,
            self._tensor(self._last_inc), self.config, self.tsdf_config, self._shape,
            self.policy.min_weight, self.policy.max_render_depth, raycast=self.policy.raycast,
            march=self._march(self.frame_poses[-1]),
        )
        self.last_render = (kf.depth_m[0], kf.gray[0])
        with trace_span("sync.map"):
            pack = pack_d.cpu().numpy().astype(np.float64)
        success = pack[16] > 0.5
        self.last_transform, self.last_success = pack[:16].reshape(4, 4), bool(success)
        if success:
            # The transform maps previous-camera points into the current
            # camera: the constant-velocity seed of the next step.
            self._last_inc = pack[:16].reshape(4, 4)
            self.renders += 1
            if self._frame_idx % self.every == 0:
                self._integrate(fd, world_d)
        else:
            self.failures += 1
            count("map.failed")
        world = pack[17:33].reshape(4, 4)
        self.frame_poses.append(world)
        self._frame_idx += 1
        return Pose(self._tensor(world))

    def trajectory(self) -> np.ndarray:
        return np.stack(self.frame_poses) if self.frame_poses else np.zeros((0, 4, 4))
