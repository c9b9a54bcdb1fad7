"""Entry ``batched_session``: ``BatchedOdometrySession.step`` over B
streams whose raw frames (RGB uint8, depth uint16) are on the card, as a
capture or decode stage on the card delivers them; each step's poses and
success flags come back to the host (a closed loop)."""

from __future__ import annotations

import torch

from portbench.harness import drive, runner


class Adapter:
    def __init__(self, cell, tier_path, frames, schedule, streams, dev):
        from dense_visual_odometry_torch.camera import CameraModel
        from dense_visual_odometry_torch.config import RobustDVOConfig

        self.cfg = RobustDVOConfig.from_json(tier_path)
        self.camera = CameraModel.create(frames.intrinsics, 1.0 / frames.depth_factor)
        self.frames, self.schedule, self.streams, self.dev = frames, schedule, streams, dev

    def inputs(self, idx):
        idx = torch.as_tensor(idx, device=self.dev)
        return self.frames.rgb[idx], self.frames.depth[idx].view(torch.uint16)

    def new_session(self):
        from dense_visual_odometry_torch.models.batched_session import BatchedOdometrySession

        return BatchedOdometrySession(self.camera, self.cfg, batch=self.streams, device=self.dev)

    def warm_fallback(self):
        """A throwaway session's jump across half the pool: the hard-motion
        trigger sends it to the gather loop, whose shapes are then warm."""
        warm = self.new_session()
        n = self.frames.rgb.shape[0]
        for f in (0, n // 2):
            warm.step(*self.inputs([f] * self.streams))
        del warm

    def step(self, session, k):
        session.step(*self.inputs(self.schedule.frames(k)))
        out = session.last_output
        return drive.pose_rows(out.pose, out.transform, out.success)

    def state_pyramids(self, session, streams):
        prev = session._state.prev
        sel = torch.as_tensor(streams, device=self.dev)
        return [g[sel].clone() for g in prev.gray], [d[sel].clone() for d in prev.depth_m]

    @staticmethod
    def level_launches() -> int:
        from dense_visual_odometry_torch.ops.cuda.level_solver import lm_level

        return lm_level.launches


def run(cell, seed, seconds, trace_on, t_start, opts=None):
    return runner.run_cell(cell, seed, seconds, trace_on, t_start, Adapter,
                           opts or runner.Options())
