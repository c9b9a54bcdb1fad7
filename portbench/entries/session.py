"""Entry ``session``: ``OdometrySession.step`` on one stream, each frame
handed over as host numpy arrays (RGB uint8, depth uint16), as a USB
camera driver delivers it, and the pose read back to the host."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import drive, runner


class Adapter:
    def __init__(self, cell, tier_path, frames, schedule, streams, dev):
        from dense_visual_odometry_torch.camera import CameraModel
        from dense_visual_odometry_torch.config import RobustDVOConfig

        if streams != 1:
            raise ValueError(f"the session entry tracks one stream, not {streams}")
        self.cfg = RobustDVOConfig.from_json(tier_path)
        self.camera = CameraModel.create(frames.intrinsics, 1.0 / frames.depth_factor)
        self.schedule, self.dev = schedule, dev
        self.rgb = frames.rgb.cpu().numpy()
        self.depth = frames.depth.cpu().numpy().view(np.uint16)

    def new_session(self):
        from dense_visual_odometry_torch.models.session import OdometrySession

        return OdometrySession(self.camera, self.cfg, device=self.dev)

    def warm_fallback(self):
        """A throwaway session's jump across half the pool, as in the
        batched entry."""
        warm = self.new_session()
        for f in (0, len(self.rgb) // 2):
            warm.step(self.rgb[f], self.depth[f])
        del warm

    def step(self, session, k):
        f = int(self.schedule.frames(k)[0])
        session.step(self.rgb[f], self.depth[f])
        out = session.last_output
        return drive.pose_rows(out.pose[None], out.transform[None], out.success[None])

    def state_pyramids(self, session, streams):
        prev = session._state.prev
        return [g[None].clone() for g in prev.gray], [d[None].clone() for d in prev.depth_m]

    @staticmethod
    def level_launches() -> int:
        from dense_visual_odometry_torch.ops.cuda.level_solver import lm_level

        return lm_level.launches


def run(cell, seed, seconds, trace_on, t_start, opts=None):
    return runner.run_cell(cell, seed, seconds, trace_on, t_start, Adapter,
                           opts or runner.Options())
