"""Multi-stream SLAM: B independent SLAM sessions sharing one batched step.

Counterpart of ``dense_visual_odometry_tpu/models/batched_slam.py``:

- one batched front-end step per frame batch preprocesses B frames, tracks
  each against its own keyframe (the keyframes stay on the device as one
  stacked ``FrameData``) and returns the per-stream ``_PK_*`` packs, read
  back with one transfer for all B streams;
- the host-side policy (promotion, pose-graph edges, windowed BA, loop
  closure, relocalization) stays per stream and reuses
  ``SlamSession.apply_step``: each stream owns a full :class:`SlamSession`.
  A promotion or relocalization takes a copy of that stream's frame and
  writes its new keyframe into its slot of the stacked tree in place.

The hard-motion fallback predicate is batch-global (``models/robust.py``),
so a stream under hard motion sends all streams to the gather path for that
batch; the results stay correct for every stream.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.models.robust import FrameData
from dense_visual_odometry_torch.models.slam import (
    _PK_DESC,
    _PK_ERROR,
    _PK_SUCCESS,
    KeyframePolicy,
    SlamSession,
    _fused_step,
    _fused_step_two,
    _host,
    _preprocess,
)
from dense_visual_odometry_torch.utils.lie import Pose


def _slice_stream(tree: FrameData, b: int) -> FrameData:
    """Stream ``b``'s unbatched copy (not a view: the stacked tree is
    written in place later)."""
    return FrameData(gray=tuple(x[b].clone() for x in tree.gray),
                     depth_m=tuple(x[b].clone() for x in tree.depth_m))


def _set_stream(batched: FrameData, item: FrameData, b: int) -> FrameData:
    """Write ``item`` into slot ``b`` of the stacked tree, in place."""
    for xs, ys in ((batched.gray, item.gray), (batched.depth_m, item.depth_m)):
        for x, y in zip(xs, ys):
            x[b].copy_(y)
    return batched


class BatchedSlamSession:
    """B independent streaming SLAM sessions sharing one batched step.
    Runs on the GPU unless ``device`` says otherwise.

    >>> slam = BatchedSlamSession(camera, cfg, n_streams=8)
    >>> for frames in zip(*sequences):           # frames: B (rgb, depth)
    ...     poses = slam.step([f[0] for f in frames], [f[1] for f in frames])
    >>> slam.sessions[0].optimized_trajectory()

    Per-stream state lives in ``self.sessions[b]``, full
    :class:`SlamSession` objects whose per-frame device work is hoisted into
    the shared batched step.
    """

    def __init__(
        self,
        camera: CameraModel,
        config: Optional[RobustDVOConfig] = None,
        n_streams: int = 8,
        policy: Optional[KeyframePolicy] = None,
        device=None,
    ):
        self.config = config or RobustDVOConfig(levels=4, use_weighter=True)
        self.n_streams = n_streams
        self.sessions: List[SlamSession] = [
            SlamSession(camera, self.config, policy, device=device)
            for _ in range(n_streams)
        ]
        self.device = self.sessions[0].device
        self.camera = camera
        self.policy = self.sessions[0].policy
        self._camera = self.sessions[0]._camera
        self._intrinsics = self.sessions[0]._intrinsics
        self._keyframes: Optional[FrameData] = None  # stacked (B, ...) tree
        # Two-step tracking: the previous frame batch stays on the device
        # like the keyframe tree; the refinement budget is the sessions'.
        self._prev_fds: Optional[FrameData] = None
        self._cfg_refine = self.sessions[0]._cfg_refine

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def step(self, images: Sequence, depths: Sequence) -> List[Pose]:
        """Advance every stream by one frame; returns B front-end poses."""
        if len(images) != self.n_streams or len(depths) != self.n_streams:
            raise ValueError(
                f"expected {self.n_streams} frames, got {len(images)}"
            )

        def stack(xs):
            if isinstance(xs[0], torch.Tensor):
                return torch.stack(list(xs))
            return np.ascontiguousarray(np.stack(xs))

        img_b, dep_b = stack(images), stack(depths)

        if self._keyframes is None:
            # First batch: every stream anchors at its first frame; the
            # stacked tree is the keyframe state.
            fd_b = _preprocess(img_b, dep_b, self._camera, self.config, self.device)
            self._keyframes = FrameData(gray=tuple(x.clone() for x in fd_b.gray),
                                        depth_m=tuple(x.clone() for x in fd_b.depth_m))
            self._prev_fds = fd_b
            return [
                sess._first_frame(_slice_stream(fd_b, b))
                for b, sess in enumerate(self.sessions)
            ]

        if self.policy.two_step_tracking:
            init_inc = np.stack([sess._last_inc for sess in self.sessions])
            prev_from_kf = np.stack(
                [np.linalg.inv(sess._rel_to_kf) for sess in self.sessions]
            )
            fd_b, _, pack_d = _fused_step_two(
                self._keyframes, self._prev_fds, img_b, dep_b, self._camera,
                self._f32(init_inc), self._f32(prev_from_kf), self.config, self._cfg_refine,
            )
        else:
            init_b = np.stack([sess.init_guess() for sess in self.sessions])
            fd_b, _, pack_d = _fused_step(
                self._keyframes, img_b, dep_b, self._camera, self._f32(init_b), self.config,
            )
        pack = _host(pack_d).astype(np.float64)  # one transfer for all streams
        self._prev_fds = fd_b
        reloc = self._group_relocalizations(fd_b, pack)

        poses = []
        for b, sess in enumerate(self.sessions):
            kf_before = sess._active_kf
            keyframe_before = sess._keyframe
            poses.append(
                sess.apply_step(
                    lambda b=b: _slice_stream(fd_b, b), pack[b],
                    reloc_thunk=reloc.get(b),
                )
            )
            if (
                sess._active_kf != kf_before
                or sess._keyframe is not keyframe_before
            ):
                # Promotion or relocalization changed this stream's
                # tracking target: patch the stacked keyframe state.
                self._keyframes = _set_stream(self._keyframes, sess._keyframe, b)
        return poses

    def _group_relocalizations(self, fd_b: FrameData, pack: np.ndarray) -> dict:
        """One dense verification for all streams that attempt
        relocalization this step -> {stream: thunk applying its result}.

        Mirrors ``SlamSession.apply_step``'s trigger (success after the
        error gate, lost counter past ``relocalize_after``); candidates come
        from the packed descriptors.  The batch has the fixed size
        ``n_streams * loop_max_candidates`` (padded by repeating row 0).
        """
        policy = self.policy
        if not policy.relocalize:
            return {}
        pending = []  # (stream, candidates)
        for b, sess in enumerate(self.sessions):
            success = pack[b][_PK_SUCCESS] > 0.5
            if success and policy.track_max_error is not None:
                success = pack[b][_PK_ERROR] <= policy.track_max_error
            if success or sess._lost_count + 1 <= policy.relocalize_after:
                continue
            cand = sess._reloc_candidates(pack[b][_PK_DESC].astype(np.float32))
            if cand:
                pending.append((b, cand))
        if not pending:
            return {}

        from dense_visual_odometry_torch.parallel.batched import (
            batched_track_pair,
            stack_frame_data,
        )

        cap = policy.loop_max_candidates
        rows = []  # (stream, keyframe_id) per verification row
        for b, cand in pending:
            padded = cand + [cand[0]] * (cap - len(cand))
            rows.extend((b, j) for _, j in padded)
        total = self.n_streams * cap
        rows = (rows + [rows[0]] * total)[:total]
        prev_b = stack_frame_data([self.sessions[b]._kf_frames[j] for b, j in rows])
        sel = torch.as_tensor([b for b, _ in rows], device=self.device)
        curr_b = FrameData(gray=tuple(x[sel] for x in fd_b.gray),
                           depth_m=tuple(x[sel] for x in fd_b.depth_m))
        eye_b = torch.eye(4, dtype=torch.float32, device=self.device).expand(total, 4, 4)
        result = batched_track_pair(
            prev_b, curr_b, self._intrinsics, self.config,
            init_guess=eye_b, last_transform=eye_b,
        )
        success = _host(result.success)
        errs = _host(result.diagnostics.error[-1]).astype(np.float64)
        transforms = _host(result.transform).astype(np.float64)

        thunks = {}
        offset = 0
        for b, cand in pending:
            lo, n = offset, len(cand)

            def thunk(b=b, cand=cand, lo=lo, n=n):
                return self.sessions[b]._reloc_apply(
                    cand, success[lo:lo + n], errs[lo:lo + n],
                    transforms[lo:lo + n],
                )

            thunks[b] = thunk
            offset += cap
        return thunks

    @property
    def num_keyframes(self) -> List[int]:
        return [sess.num_keyframes for sess in self.sessions]
