"""Keyframe-based dense SLAM: frame-to-keyframe tracking + windowed BA.

Counterpart of ``dense_visual_odometry_tpu/models/slam.py``:

- the front end tracks every frame against the current keyframe (drift
  accumulates only at keyframe switches);
- a frame is promoted to keyframe when motion or image overlap leaves the
  validity envelope (translation / rotation / valid-pixel-ratio policy);
- each keyframe switch records a pose-graph edge weighted by the tracker's
  final photometric Hessian, and the last W keyframe poses are
  re-optimized by :mod:`dense_visual_odometry_torch.models.posegraph`;
- loop closures (pose-proximate or appearance-matched keyframes, verified
  by one batched dense solve) add edges, and after sustained tracking loss
  the frame is relocalized against the retained keyframes.

The per-frame device half (:func:`_fused_step`, :func:`_fused_step_two`)
preprocesses the frame, tracks it and gathers every scalar the host policy
needs into one packed float32 vector (the ``_PK_*`` layout), read back with
one transfer.  The tracker itself reads the device on the host inside its
loops (``models/robust.py``), so a step costs more host reads than that one;
pixel data stays on the device throughout.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.models import posegraph
from dense_visual_odometry_torch.models.robust import (
    FrameData,
    preprocess_frame,
    resolve_device,
    track_pair,
)
from dense_visual_odometry_torch.ops import pyramid as pyr_ops
from dense_visual_odometry_torch.utils.lie import Pose, se3

logger = logging.getLogger("dvo.slam")


@dataclasses.dataclass(frozen=True)
class KeyframePolicy:
    """When to promote a frame to keyframe, and how to close loops."""

    max_translation: float = 0.15  # meters of motion vs the keyframe
    max_rotation: float = 0.15  # radians vs the keyframe
    min_valid_ratio: float = 0.5  # valid px at finest level / at keyframe time
    window: int = 8  # BA window length (keyframes)
    # Loop closure: a past keyframe (at least ``loop_min_gap`` keyframes
    # back, FrameData still retained) becomes a candidate when it lies
    # within ``loop_radius`` meters and ``loop_angle`` radians of the new
    # keyframe's pose, or (``place_recognition``) its appearance descriptor
    # (a pooled, zero-mean, L2-normalized coarse-level thumbnail: the dot
    # product is a ZNCC score) matches with similarity >=
    # ``loop_min_similarity``.  Candidates are ranked by similarity; the top
    # ``loop_max_candidates`` are verified in one batched dense solve, and
    # a pair whose solve succeeds with mean photometric error <=
    # ``loop_max_error`` becomes a graph edge.
    loop_closure: bool = True
    loop_radius: float = 0.5
    loop_angle: float = 0.5
    loop_min_gap: int = 3
    loop_max_error: float = 400.0
    loop_max_candidates: int = 2  # dense verifications per new keyframe
    place_recognition: bool = True
    loop_min_similarity: float = 0.90  # ZNCC descriptor score gate
    max_stored_keyframes: int = 64  # FrameData retained for loop checks
    # Redescending robust kernel threshold for BA edges (Mahalanobis
    # units); None = quadratic.
    ba_robust_delta: Optional[float] = None
    # Tracking-loss gate: a solve whose final mean photometric error
    # exceeds this counts as lost even when the solver reports success.
    # A lost frame freezes the pose.  None disables.
    track_max_error: Optional[float] = None
    # Relocalization: after more than ``relocalize_after`` consecutive
    # lost frames, match the frame's descriptor against all retained
    # keyframes, verify the best candidates in one batched solve, and
    # re-anchor tracking at the best verified keyframe.
    relocalize: bool = True
    relocalize_after: int = 3
    relocalize_min_similarity: float = 0.80
    # Two-step tracking: (1) solve frame-to-previous-frame (a small warp),
    # then (2) refine frame-to-keyframe from the composed estimate under
    # the per-level caps ``refine_max_iterations`` (index 0 = finest).  The
    # keyframe edge, Hessian and policy scalars come from the refinement.
    two_step_tracking: bool = False
    refine_max_iterations: tuple = (6, 4, 3, 3)


def _batch1(fd: FrameData) -> FrameData:
    return FrameData(gray=tuple(g[None] for g in fd.gray),
                     depth_m=tuple(d[None] for d in fd.depth_m))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class SlamSession:
    """Host-facing streaming SLAM pipeline.  Runs on the GPU unless
    ``device`` says otherwise; without a GPU the default raises.

    >>> slam = SlamSession(camera, RobustDVOConfig.from_json("configs/tpu_slam.json"))
    >>> for rgb, depth in seq:
    ...     pose = slam.step(rgb, depth)
    >>> slam.optimized_trajectory()   # all frame poses after windowed BA
    """

    def __init__(
        self,
        camera: CameraModel,
        config: Optional[RobustDVOConfig] = None,
        policy: Optional[KeyframePolicy] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.camera = camera
        self.config = config or RobustDVOConfig(levels=4, use_weighter=True)
        self.policy = policy or KeyframePolicy()
        self._intrinsics = camera.intrinsics.to(self.device)
        self._camera = CameraModel(intrinsics=self._intrinsics,
                                   depth_scale=camera.depth_scale)

        self._keyframe: Optional[FrameData] = None
        self._kf_frames: List[Optional[FrameData]] = []  # retained for loops
        self._kf_desc: List[np.ndarray] = []  # place-recognition descriptors
        self._kf_valid_count: float = 0.0
        # Keyframe graph state (host lists; poses are small).
        self.keyframe_poses: List[np.ndarray] = []  # camera-to-world, 4x4
        self.keyframe_indices: List[int] = []  # frame index of each keyframe
        self.loop_closures: List[tuple] = []  # accepted (j, k, error)
        self._edges_i: List[int] = []
        self._edges_j: List[int] = []
        self._edges_meas: List[np.ndarray] = []
        self._edges_info: List[np.ndarray] = []
        # Per-frame outputs.
        self.frame_poses: List[np.ndarray] = []  # world poses (composed)
        self._frame_kf: List[int] = []  # owning keyframe per frame
        self._frame_rel: List[np.ndarray] = []  # kf->frame relative pose
        self._rel_to_kf = np.eye(4)  # current frame-in-keyframe pose
        self._last_inc = np.eye(4)  # last frame-to-frame motion (init guess)
        self._frame_idx = 0
        self.last_result = None
        # The active keyframe is normally the latest promoted one, but
        # relocalization can re-anchor at any retained keyframe.
        self._active_kf = -1
        self._lost_count = 0
        self.relocalizations: List[tuple] = []  # (frame_idx, keyframe_id)
        # Two-step tracking: the previous frame's FrameData (on the device)
        # and the short-budget refinement config.
        self._prev_fd: Optional[FrameData] = None
        if self.policy.two_step_tracking:
            caps = tuple(self.policy.refine_max_iterations)
            caps = (
                caps[: self.config.levels]
                + (caps[-1],) * max(0, self.config.levels - len(caps))
            )
            self._cfg_refine = dataclasses.replace(
                self.config, max_iterations_per_level=caps
            )
        else:
            self._cfg_refine = None

    # -- internals ---------------------------------------------------------
    def _valid_count(self, fd: FrameData) -> float:
        return float(torch.sum(fd.depth_m[0] > 0.0))

    def _promote(
        self,
        fd: FrameData,
        world_pose: np.ndarray,
        measured_from_prev_kf,
        desc: Optional[np.ndarray] = None,
        valid_count: Optional[float] = None,
    ):
        """Make ``fd`` the keyframe with pose ``world_pose``; ``desc`` and
        ``valid_count`` come from the step's pack where the caller has it."""
        kf_id = len(self.keyframe_poses)
        if measured_from_prev_kf is not None:
            # The odometry edge connects the keyframe the measurement was
            # tracked against (a relocalization may have re-anchored it).
            meas, info = measured_from_prev_kf
            self._edges_i.append(self._active_kf)
            self._edges_j.append(kf_id)
            self._edges_meas.append(meas)
            self._edges_info.append(info)
        self.keyframe_poses.append(world_pose.copy())
        self.keyframe_indices.append(self._frame_idx)
        self._keyframe = fd
        self._kf_frames.append(fd)
        self._kf_desc.append(
            _host(_frame_descriptor(fd.gray[-1])) if desc is None else desc
        )
        if len(self._kf_frames) > self.policy.max_stored_keyframes:
            # Drop the oldest retained FrameData (poses/edges are kept).
            self._kf_frames[len(self._kf_frames) - self.policy.max_stored_keyframes - 1] = None
        self._kf_valid_count = (
            self._valid_count(fd) if valid_count is None else valid_count
        )
        self._rel_to_kf = np.eye(4)
        self._active_kf = kf_id
        if measured_from_prev_kf is not None:
            if self.policy.loop_closure:
                self._try_loop_closures(kf_id, fd)
            if len(self.keyframe_poses) >= 3:
                self._optimize_window()

    def _loop_candidates(self, kf_id: int):
        """-> list of (similarity, j, rel) loop candidates, best first
        (numpy over every eligible past keyframe)."""
        pose_k = self.keyframe_poses[kf_id]
        js = np.asarray(
            [
                j
                for j in range(0, kf_id - self.policy.loop_min_gap + 1)
                if j < len(self._kf_frames) and self._kf_frames[j] is not None
            ],
            np.int64,
        )
        if js.size == 0:
            return []
        poses_j = np.stack([self.keyframe_poses[j] for j in js])
        rel = np.linalg.inv(poses_j) @ pose_k  # pose of k in each j
        dist = np.linalg.norm(rel[:, :3, 3], axis=-1)
        ang = np.arccos(
            np.clip((np.trace(rel[:, :3, :3], axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
        )
        sim = np.stack([self._kf_desc[j] for j in js]) @ self._kf_desc[kf_id]
        near = (dist <= self.policy.loop_radius) & (ang <= self.policy.loop_angle)
        eligible = near
        if self.policy.place_recognition:
            # Appearance catches revisits the (drifted) pose gate misses.
            eligible = eligible | (sim >= self.policy.loop_min_similarity)
        order = np.argsort(-sim)
        return [
            (float(sim[l]), int(js[l]), rel[l])
            for l in order
            if eligible[l]
        ][: self.policy.loop_max_candidates]

    def _verify(self, frames: List[FrameData], fd: FrameData, init: np.ndarray):
        """Dense-align each of ``frames`` to ``fd`` in one batched solve from
        ``init`` (B, 4, 4) -> host (success, final errors, transforms,
        Hessians)."""
        from dense_visual_odometry_torch.parallel.batched import (
            batched_track_pair,
            stack_frame_data,
        )

        cap = len(frames)
        init_t = torch.as_tensor(np.array(init, np.float32), device=self.device)
        result = batched_track_pair(
            stack_frame_data(frames), stack_frame_data([fd] * cap), self._intrinsics,
            self.config, init_guess=init_t, last_transform=init_t,
        )
        return (_host(result.success), _host(result.diagnostics.error[-1]).astype(np.float64),
                _host(result.transform).astype(np.float64),
                _host(result.hessian).astype(np.float64))

    def _try_loop_closures(self, kf_id: int, fd: FrameData) -> None:
        """Dense-verify loop candidates and add accepted relative-pose edges.

        All candidates are verified in one batched solve with a fixed batch
        of ``loop_max_candidates`` (padded by repeating the first)."""
        candidates = self._loop_candidates(kf_id)
        if not candidates:
            return
        cap = self.policy.loop_max_candidates
        padded = candidates + [candidates[0]] * (cap - len(candidates))
        # Alignment keyframe_j -> keyframe_k seeded at the current estimate:
        # rel = X_j^-1 X_k is the pose of k in j, so transform ~= rel^-1.
        init = np.stack([np.linalg.inv(rel) for _, _, rel in padded]).astype(np.float32)
        success, errs, transforms, hessians = self._verify(
            [self._kf_frames[j] for _, j, _ in padded], fd, init)
        for b, (_, j, _) in enumerate(candidates):
            if not (bool(success[b]) and errs[b] <= self.policy.loop_max_error):
                continue
            if not _invertible_pose(transforms[b]):
                logger.warning(
                    "degenerate-context: kf=%d cand=%d err=%.2f "
                    "count-like hessian trace=%.3e init_det4=%.6f "
                    "init_row3=%s",
                    kf_id, j, float(errs[b]),
                    float(np.trace(hessians[b])),
                    float(np.linalg.det(init[b])),
                    init[b, 3].tolist(),
                )
                continue
            meas = _safe_inv_pose(transforms[b])
            if meas is None:
                continue
            info = hessians[b]
            if not np.all(np.isfinite(info)) or np.trace(info) <= 0:
                info = np.eye(6)
            self._edges_i.append(j)
            self._edges_j.append(kf_id)
            self._edges_meas.append(meas)
            self._edges_info.append(info)
            self.loop_closures.append((j, kf_id, float(errs[b])))

    def _reloc_candidates(self, desc: np.ndarray):
        """-> [(similarity, keyframe_id), ...] relocalization candidates,
        best first, gated on ``relocalize_min_similarity`` and capped at
        ``loop_max_candidates``; host-only given the frame descriptor."""
        js = [
            j
            for j in range(len(self._kf_frames))
            if self._kf_frames[j] is not None
        ]
        if not js:
            return []
        sims = np.stack([self._kf_desc[j] for j in js]) @ desc
        order = np.argsort(-sims)
        return [
            (float(sims[l]), js[l])
            for l in order
            if sims[l] >= self.policy.relocalize_min_similarity
        ][: self.policy.loop_max_candidates]

    def _reloc_apply(self, cand, success, errs, transforms) -> bool:
        """Re-anchor at the best verified candidate (lowest final error under
        the ``loop_max_error`` gate); the arrays are host rows aligned with
        ``cand``."""
        best = None
        for b, (_, j) in enumerate(cand):
            if not (bool(success[b]) and errs[b] <= self.policy.loop_max_error):
                continue
            if not _invertible_pose(transforms[b]):
                continue
            if best is None or errs[b] < errs[best[0]]:
                best = (b, j)
        if best is None:
            return False
        b, j = best
        rel = _safe_inv_pose(transforms[b])
        if rel is None:
            return False
        self._active_kf = j
        self._keyframe = self._kf_frames[j]
        self._kf_valid_count = self._valid_count(self._keyframe)
        self._rel_to_kf = rel
        self._last_inc = np.eye(4)
        self.relocalizations.append((self._frame_idx, j))
        return True

    def _relocalize(self, fd: FrameData) -> bool:
        """Appearance-based recovery after sustained tracking loss: verify
        the best candidates from the identity in one batched solve (the
        loop verification's batch) and re-anchor at the best."""
        desc = _host(_frame_descriptor(fd.gray[-1]))
        cand = self._reloc_candidates(desc)
        if not cand:
            return False
        cap = self.policy.loop_max_candidates
        padded = cand + [cand[0]] * (cap - len(cand))
        eye_b = np.broadcast_to(np.eye(4, dtype=np.float32), (cap, 4, 4))
        success, errs, transforms, _ = self._verify(
            [self._kf_frames[j] for _, j in padded], fd, eye_b)
        return self._reloc_apply(cand, success, errs, transforms)

    def _optimize_window(self):
        """Windowed BA with fixed shapes: poses padded to the window length
        with identities, edges padded to ``window * (1 +
        loop_max_candidates)`` with zero-information identities.  The
        padding is part of the result: the solver's damping scales with the
        trace over the padded dimension."""
        w = self.policy.window
        k_total = len(self.keyframe_poses)
        start = max(0, k_total - w)
        k_window = k_total - start
        idx = {g: l for l, g in enumerate(range(start, k_total))}
        sel = [
            e
            for e in range(len(self._edges_i))
            if self._edges_i[e] >= start and self._edges_j[e] >= start
        ]
        if not sel:
            return
        edge_cap = w * (1 + self.policy.loop_max_candidates)
        sel = sel[-edge_cap:]
        e_used = len(sel)
        eye4 = np.eye(4)
        meas = np.stack(
            [self._edges_meas[e] for e in sel]
            + [eye4] * (edge_cap - e_used)
        )
        info = np.zeros((edge_cap, 6, 6))
        for l, e in enumerate(sel):
            info[l] = self._edges_info[e]
        i_idx = np.zeros((edge_cap,), np.int32)
        j_idx = np.zeros((edge_cap,), np.int32)
        i_idx[:e_used] = [idx[self._edges_i[e]] for e in sel]
        j_idx[:e_used] = [idx[self._edges_j[e]] for e in sel]

        poses = np.stack(
            list(self.keyframe_poses[start:]) + [eye4] * (w - k_window)
        )
        out = posegraph.optimize_pose_graph(
            self._f32(poses), self._edges(i_idx, j_idx, meas, info), max_iterations=10,
            robust_delta=self.policy.ba_robust_delta,
        )
        optimized = _host(out.poses).astype(np.float64)
        if np.all(np.isfinite(optimized)):
            for l, g in enumerate(range(start, k_total)):
                self.keyframe_poses[g] = optimized[l]

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _edges(self, i_idx, j_idx, meas, info) -> posegraph.PoseGraphEdges:
        return posegraph.PoseGraphEdges(
            i=torch.as_tensor(np.asarray(i_idx, np.int32), device=self.device),
            j=torch.as_tensor(np.asarray(j_idx, np.int32), device=self.device),
            measurement=self._f32(meas),
            information=self._f32(info),
        )

    # -- public API --------------------------------------------------------
    def step(self, image, depth) -> Pose:
        """Process one frame; returns its (front-end) world pose."""
        if self._keyframe is None:
            fd = _preprocess(image, depth, self._camera, self.config, self.device)
            return self._first_frame(fd)

        # Track the frame against the keyframe from the composed motion so
        # far plus the last inter-frame increment (constant velocity in the
        # keyframe's frame).
        keyframe_b, image_b, depth_b = _batch1(self._keyframe), image[None], depth[None]
        if self.policy.two_step_tracking and self._prev_fd is not None:
            fd_b, result, pack_d = _fused_step_two(
                keyframe_b, _batch1(self._prev_fd), image_b, depth_b, self._camera,
                self._f32(self._last_inc[None]),
                self._f32(np.linalg.inv(self._rel_to_kf)[None]),
                self.config, self._cfg_refine,
            )
        else:
            fd_b, result, pack_d = _fused_step(
                keyframe_b, image_b, depth_b, self._camera,
                self._f32(self.init_guess()[None]), self.config,
            )
        fd = FrameData(gray=tuple(g[0] for g in fd_b.gray),
                       depth_m=tuple(d[0] for d in fd_b.depth_m))
        self.last_result = result
        pack = _host(pack_d[0]).astype(np.float64)  # the pack's one transfer
        self._prev_fd = fd
        return self.apply_step(lambda: fd, pack)

    def _first_frame(self, fd: FrameData) -> Pose:
        """Anchor the session at its first frame (keyframe 0, identity)."""
        pose = np.eye(4)
        self._prev_fd = fd
        self._promote(fd, pose, None)
        self.frame_poses.append(pose)
        self._frame_kf.append(0)
        self._frame_rel.append(np.eye(4))
        self._frame_idx += 1
        return Pose.from_matrix(pose)

    def init_guess(self) -> np.ndarray:
        """Constant-velocity warm start for the next frame-to-keyframe
        solve (in the keyframe's frame)."""
        return (
            self._last_inc @ np.linalg.inv(self._rel_to_kf)
        ).astype(np.float32)

    def apply_step(self, fd_thunk, pack: np.ndarray, reloc_thunk=None) -> Pose:
        """Host-side policy half of :meth:`step`.

        ``fd_thunk`` lazily yields the frame's ``FrameData`` (only needed on
        promotion or relocalization); ``pack`` is the ``_PK_*`` vector on
        the host.  ``reloc_thunk`` (optional, () -> bool) replaces the
        session's own relocalization attempt: batched callers pass one that
        applies results verified for many streams at once.
        """
        fd_cache = []

        def fd():
            if not fd_cache:
                fd_cache.append(fd_thunk())
            return fd_cache[0]

        success = pack[_PK_SUCCESS] > 0.5
        transform = pack[_PK_TRANSFORM].reshape(4, 4)
        if success and self.policy.track_max_error is not None:
            # A finite estimate over enough pixels can still be a wrong
            # alignment; the residual level says so.
            success = pack[_PK_ERROR] <= self.policy.track_max_error

        if success:
            rel = _safe_inv_pose(transform)  # keyframe -> frame pose
            success = rel is not None
        if success:
            self._lost_count = 0
            prev_rel = self._rel_to_kf
            self._last_inc = np.linalg.inv(rel) @ prev_rel  # frame motion
            self._rel_to_kf = rel
        else:
            self._lost_count += 1
            if (
                self.policy.relocalize
                and self._lost_count > self.policy.relocalize_after
                and (
                    reloc_thunk() if reloc_thunk is not None
                    else self._relocalize(fd())
                )
            ):
                self._lost_count = 0
        world = self.keyframe_poses[self._active_kf] @ self._rel_to_kf

        self.frame_poses.append(world)
        self._frame_kf.append(self._active_kf)
        self._frame_rel.append(self._rel_to_kf.copy())

        if success and self._needs_keyframe(pack):
            info = pack[_PK_HESSIAN].reshape(6, 6)
            # Guard: information must be finite and PSD-ish; else identity.
            if not np.all(np.isfinite(info)) or np.trace(info) <= 0:
                info = np.eye(6)
            meas = self._rel_to_kf  # X_prev_kf^-1 @ X_new_kf
            self._promote(
                fd(), world, (meas.copy(), info),
                desc=pack[_PK_DESC].astype(np.float32),
                valid_count=float(pack[_PK_VALID]),
            )

        self._frame_idx += 1
        return Pose.from_matrix(world)

    def _needs_keyframe(self, pack: np.ndarray) -> bool:
        xi = pack[_PK_XI]
        trans = float(np.linalg.norm(xi[:3]))
        rot = float(np.linalg.norm(xi[3:]))
        ratio = (
            float(pack[_PK_VALID]) / self._kf_valid_count
            if self._kf_valid_count > 0
            else 0.0
        )
        return (
            trans > self.policy.max_translation
            or rot > self.policy.max_rotation
            or ratio < self.policy.min_valid_ratio
        )

    def optimize_full(self, max_iterations: int = 20) -> None:
        """Global BA over all keyframes and edges (loop closures outside the
        sliding window included); call once at the end of a sequence."""
        if len(self.keyframe_poses) < 3 or not self._edges_i:
            return
        out = posegraph.optimize_pose_graph(
            self._f32(np.stack(self.keyframe_poses)),
            self._edges(self._edges_i, self._edges_j, np.stack(self._edges_meas),
                        np.stack(self._edges_info)),
            max_iterations=max_iterations,
            robust_delta=self.policy.ba_robust_delta,
        )
        optimized = _host(out.poses).astype(np.float64)
        if np.all(np.isfinite(optimized)):
            for g in range(len(self.keyframe_poses)):
                self.keyframe_poses[g] = optimized[g]

    def refine_dense(
        self,
        grid_stride: int = 8,
        window: int = 2,
        config=None,
        update_depths: bool = False,
        max_depth_ratio: float = 1.5,
    ):
        """Dense refinement: joint pose + inverse-depth BA over all retained
        keyframes (:mod:`dense_visual_odometry_torch.models.dense_ba`).

        Besides the index-window edges, every accepted loop closure whose
        endpoints are both retained joins the target table.  Keyframe poses
        are updated in place, re-anchored to the first pose before the
        refinement; returns the ``DenseBAResult`` (None with fewer than two
        retained keyframes).  ``update_depths=True`` writes the refined
        depths back into the keyframes' pyramids
        (:meth:`_apply_depth_feedback`).
        """
        from dense_visual_odometry_torch.models.dense_ba import (
            DenseBAConfig,
            build_dense_ba_data,
            optimize_dense_ba,
        )

        ks = [k for k, fd in enumerate(self._kf_frames) if fd is not None]
        if len(ks) < 2:
            return None
        pos_of = {k: i for i, k in enumerate(ks)}
        grays = [self._kf_frames[k].gray[0] for k in ks]
        depths = [self._kf_frames[k].depth_m[0] for k in ks]
        poses0 = np.stack([self.keyframe_poses[k] for k in ks])

        # Index-window targets + retained loop-closure pairs.
        n = len(ks)
        rows = [
            {t for t in range(o - window, o + window + 1) if t != o and 0 <= t < n}
            for o in range(n)
        ]
        for j, k, _err in self.loop_closures:
            if j in pos_of and k in pos_of:
                rows[pos_of[j]].add(pos_of[k])
                rows[pos_of[k]].add(pos_of[j])
        m = max(len(r) for r in rows)
        targets = np.full((n, m), -1, np.int64)
        for o, r in enumerate(rows):
            targets[o, : len(r)] = sorted(r)

        data = build_dense_ba_data(
            grays, depths, self._intrinsics,
            grid_stride=grid_stride, window=window, targets=targets, device=self.device,
        )
        result = optimize_dense_ba(self._f32(poses0), data, config or DenseBAConfig())
        refined = _host(result.poses).astype(np.float64)
        if not np.all(np.isfinite(refined)):
            return result
        # Keep the world frame: re-anchor to the first pose before the
        # refinement (the gauge prior holds it; this removes what is left).
        align = poses0[0] @ np.linalg.inv(refined[0])
        refined = np.einsum("ij,njk->nik", align, refined)
        for i, k in enumerate(ks):
            self.keyframe_poses[k] = refined[i]
        if update_depths:
            self._apply_depth_feedback(ks, data, result.inv_depth, grid_stride,
                                       max_depth_ratio)
        return result

    def _apply_depth_feedback(
        self, ks, data, inv_depth: torch.Tensor, grid_stride: int, max_depth_ratio: float
    ) -> None:
        """Write BA-refined inverse depths back into the keyframes' pyramids,
        on the device: the per-grid-point ratio z_refined / z_measured,
        clamped to [1/max_depth_ratio, max_depth_ratio], upsampled
        bilinearly with half-pixel centres (the JAX package's
        ``cv2.resize(INTER_LINEAR)``), multiplied into the measured depth,
        and the depth pyramid rebuilt."""
        h, w = self._kf_frames[ks[0]].depth_m[0].shape
        gh = len(range(0, h, grid_stride))
        gw = len(range(0, w, grid_stride))
        inv0 = data.inv_depth0
        valid = data.valid > 0.5
        for i, k in enumerate(ks):
            # Ratio in depth space: z_ref / z_meas = inv0 / inv_refined.
            ok = valid[i] & (inv_depth[i] > 1e-6)
            ratio = torch.where(
                ok,
                torch.clamp(inv0[i] / inv_depth[i], 1.0 / max_depth_ratio, max_depth_ratio),
                torch.ones_like(inv0[i]),
            )
            ratio_up = F.interpolate(
                ratio.reshape(1, 1, gh, gw), size=(h, w), mode="bilinear",
                align_corners=False,
            )[0, 0]
            fd = self._kf_frames[k]
            new_fd = FrameData(
                gray=fd.gray,
                depth_m=pyr_ops.build_pyramid(fd.depth_m[0] * ratio_up, len(fd.depth_m)),
            )
            self._kf_frames[k] = new_fd
            if k == self._active_kf:
                self._keyframe = new_fd

    def optimized_trajectory(self) -> np.ndarray:
        """(N, 4, 4) world poses for every frame, re-anchored to the
        BA-optimized keyframe poses."""
        out = []
        for kf, rel in zip(self._frame_kf, self._frame_rel):
            out.append(self.keyframe_poses[kf] @ rel)
        return np.stack(out) if out else np.zeros((0, 4, 4))

    @property
    def num_keyframes(self) -> int:
        return len(self.keyframe_poses)


def _invertible_pose(t: np.ndarray, tol: float = 0.1) -> bool:
    """A verification transform is usable as a graph edge only if it is
    finite and a rigid pose (|det R - 1| and |det T - det R| within
    ``tol``): a degenerate solve rejects the candidate and never crashes
    the session."""
    ok = bool(
        np.all(np.isfinite(t))
        and abs(float(np.linalg.det(t[:3, :3])) - 1.0) <= tol
        and abs(float(np.linalg.det(t)) - float(np.linalg.det(t[:3, :3])))
        <= tol
    )
    if not ok:
        logger.warning("rejected degenerate verification transform:\n%r", t)
    return ok


def _safe_inv_pose(t: np.ndarray):
    """``np.linalg.inv`` that returns None (logging the matrix) instead of
    raising: callers treat the solve as failed."""
    try:
        return np.linalg.inv(t)
    except np.linalg.LinAlgError:
        logger.warning("singular pose from solver:\n%r", t)
        return None


def _frame_descriptor(gray_coarse: torch.Tensor, dh: int = 8, dw: int = 12) -> torch.Tensor:
    """Appearance descriptor for place recognition: the coarsest gray level
    (..., h, w) resized to a (dh, dw) thumbnail with linear antialiasing
    (as ``jax.image.resize(..., "linear")``, which antialiases when it
    downsamples), zero-meaned and L2-normalized, so that the dot product of
    two descriptors is a ZNCC score -> (..., dh * dw)."""
    lead = gray_coarse.shape[:-2]
    h, w = gray_coarse.shape[-2:]
    d = F.interpolate(
        gray_coarse.reshape(-1, 1, h, w).to(torch.float32), size=(dh, dw), mode="bilinear",
        align_corners=False, antialias=True,
    ).reshape(*lead, dh * dw)
    d = d - torch.mean(d, dim=-1, keepdim=True)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-6)


def _preprocess(image, depth, camera: CameraModel, cfg: RobustDVOConfig, device) -> FrameData:
    return preprocess_frame(
        image, depth, camera,
        levels=cfg.levels, max_distance=cfg.max_distance,
        quantize=cfg.quantize_intensity, device=device,
    )


# Layout of the scalar pack of one frame: every host-side decision input in
# one float32 vector, read back with one transfer.
_PK_TRANSFORM = slice(0, 16)  # (4,4) frame-to-keyframe estimate, row-major
_PK_SUCCESS = 16  # 1.0 / 0.0
_PK_ERROR = 17  # finest-level final mean weighted squared residual
_PK_XI = slice(18, 24)  # se3.log(transform): [:3] trans, [3:] rot
_PK_VALID = 24  # valid-depth pixel count at the finest level
_PK_HESSIAN = slice(25, 61)  # (6,6) finest-level J^T W J, row-major
_PK_DESC = slice(61, 157)  # 96-float place-recognition descriptor
_PK_SIZE = 157


def _pack(result, fd_b: FrameData) -> torch.Tensor:
    """(B, _PK_SIZE) packs from a batched result and its batched frames."""
    b = result.transform.shape[0]
    return torch.cat([
        result.transform.reshape(b, 16),
        result.success.to(torch.float32).reshape(b, 1),
        result.diagnostics.error[-1].reshape(b, 1),
        se3.log(result.transform).reshape(b, 6),
        torch.sum(fd_b.depth_m[0] > 0.0, dim=(-2, -1), dtype=torch.float32).reshape(b, 1),
        result.hessian.reshape(b, 36),
        _frame_descriptor(fd_b.gray[-1]),
    ], dim=-1)


def _two_step_track(keyframes_b, prev_b, fd_b, camera, init_inc, prev_from_kf, cfg, cfg_refine):
    """Frame-to-previous-frame solve, composed into the keyframe's frame,
    then the short frame-to-keyframe refinement; batched (B, ...) inputs."""
    r1 = track_pair(prev_b, fd_b, camera, cfg, init_guess=init_inc, last_transform=init_inc)
    init2 = r1.transform @ prev_from_kf
    # Fall back to the plain composed seed if step 1 failed.
    init2 = torch.where(r1.success[:, None, None], init2, init_inc @ prev_from_kf)
    return track_pair(keyframes_b, fd_b, camera, cfg_refine,
                      init_guess=init2, last_transform=init2)


def _fused_step(keyframes: FrameData, images, depths, camera: CameraModel,
                init_guess: torch.Tensor, cfg: RobustDVOConfig):
    """B SLAM front-end steps (the JAX package's ``_fused_step`` and
    ``_fused_step_batched`` in one): preprocess the frames, track each
    against its keyframe, and gather the ``_PK_*`` packs.

    keyframes : batched (B, ...) ``FrameData``; images, depths (B, ...).
    init_guess : (B, 4, 4) frame-to-keyframe seeds.
    -> (fd_b, result, pack_b (B, _PK_SIZE)) on the device.
    """
    fd = _preprocess(images, depths, camera, cfg, init_guess.device)
    result = track_pair(keyframes, fd, camera, cfg,
                        init_guess=init_guess, last_transform=init_guess)
    return fd, result, _pack(result, fd)


def _fused_step_two(keyframes: FrameData, prev_fds: FrameData, images, depths,
                    camera: CameraModel, init_inc: torch.Tensor,
                    prev_from_kf: torch.Tensor, cfg: RobustDVOConfig,
                    cfg_refine: RobustDVOConfig):
    """B two-step SLAM front-end steps (``KeyframePolicy.two_step_tracking``;
    the JAX package's ``_fused_step_two`` and ``_fused_step_two_batched``).

    init_inc : (B, 4, 4) expected frame-to-frame transforms (points_prev ->
        points_curr), the constant-velocity seeds for step 1.
    prev_from_kf : (B, 4, 4) keyframe-camera -> previous-frame camera.
    -> (fd_b, result, pack_b) on the device.
    """
    fd = _preprocess(images, depths, camera, cfg, init_inc.device)
    result = _two_step_track(keyframes, prev_fds, fd, camera, init_inc, prev_from_kf,
                             cfg, cfg_refine)
    return fd, result, _pack(result, fd)
