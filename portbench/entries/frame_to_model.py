"""Entry ``frame_to_model``: KinectFusion on one stream through
``FrameToModelTracker.step(rgb, depth)``, each frame handed over as host
numpy arrays (RGB uint8, depth uint16) as a USB camera driver delivers it,
and the pose read back to the host.

The configuration's ``volume`` gives the TSDF (resolution, extent, origin,
truncation, weight cap) and the policy (a render every frame, the volume
march at ``march_step`` of the truncation, which has to be the port's).  The run, in the order of
``runner.run_cell``: the frames on the device, a throwaway tracker's
steps (its first frame, a jump across half the pool, one more), the cell's
tracker warmed by ``warmup_steps`` steps, the measured window, with
``--trace 1`` the host reads and the profiled steps with the port's tracer
on, then the memory peak and the judgement (``harness/map_check.py``).  In
the window, the sampled steps copy the volume before they run and keep
their render.  The device's ``memory_peak_bytes`` is the program's own, read
before the first copy; ``memory_peak_with_copies_bytes`` adds the copies.
"""

from __future__ import annotations

import json
import statistics
import time
from typing import Optional

import numpy as np
import torch

from portbench.harness import drive, map_check, map_trace, runner, trace
from portbench.reference import kinfu


def geometry(cell, resolution: Optional[int] = None) -> kinfu.Geometry:
    """The configuration's volume; at another ``resolution`` the cube and
    the truncation in voxels stay as stated."""
    v = cell.config["volume"]
    n = resolution or v["resolution"]
    voxel = v["extent_m"] / n
    return kinfu.Geometry(dims=(n, n, n), voxel=voxel, origin=tuple(v["origin"]),
                          truncation=v["truncation_m"] * v["resolution"] / n,
                          max_weight=float(v["max_weight"]), min_depth=v["min_depth"],
                          min_weight=v["min_weight"], max_depth=v["max_render_depth"])


def policy(cell, geo: kinfu.Geometry):
    """The tracker's policy: a render every frame by the volume march.  A
    port without the volume march (no ``VOLUME_MARCH_STEP``) refuses it,
    before any frame is made."""
    from dense_visual_odometry_torch.models.frame_to_model import ModelTrackerPolicy
    from dense_visual_odometry_torch.models.tsdf import VOLUME_MARCH_STEP

    if cell.config["volume"]["march_step"] != VOLUME_MARCH_STEP:
        raise ValueError(f"the port marches every {VOLUME_MARCH_STEP} truncations, "
                         f"not {cell.config['volume']['march_step']}")
    return ModelTrackerPolicy(render_every_frame=True, raycast="volume",
                              min_weight=geo.min_weight, max_render_depth=geo.max_depth)


def level_launches() -> int:
    from dense_visual_odometry_torch.ops.cuda.level_solver import lm_level

    return lm_level.launches


class Tracking:
    """The port's tracker as the cell builds it."""

    def __init__(self, cell, geo: kinfu.Geometry, frames, dev):
        from dense_visual_odometry_torch.camera import CameraModel
        from dense_visual_odometry_torch.config import RobustDVOConfig
        from dense_visual_odometry_torch.models.tsdf import TSDFConfig

        self.policy = policy(cell, geo)
        self.tsdf = TSDFConfig(dims=geo.dims, voxel_size=geo.voxel, origin=geo.origin,
                               truncation=geo.truncation, max_weight=geo.max_weight,
                               min_depth=geo.min_depth)
        self.cfg = RobustDVOConfig.from_json(cell.root / cell.config["tracker_config"])
        self.dev = dev
        self.frames = frames
        self.camera = CameraModel.create(frames.intrinsics, 1.0 / frames.depth_factor)
        self.rgb = frames.rgb.cpu().numpy()
        self.depth = frames.depth.cpu().numpy().view(np.uint16)

    def new(self):
        from dense_visual_odometry_torch.models.frame_to_model import FrameToModelTracker

        return FrameToModelTracker(self.camera, self.cfg, self.tsdf, self.policy, device=self.dev)

    def step(self, tracker, f: int) -> np.ndarray:
        """One frame in, its pose read back -> (1, ROW)."""
        pose = tracker.step(self.rgb[f], self.depth[f]).matrix.cpu().numpy()
        row = np.zeros((1, drive.ROW), np.float32)
        row[0, drive.POSE] = pose.reshape(16)
        row[0, drive.MOTION] = np.asarray(tracker.last_transform, np.float32).reshape(16)
        row[0, drive.SUCCESS] = float(tracker.last_success)
        return row


def run(cell, seed, seconds, trace_on, t_start, opts=None):
    opts = opts or map_check.Options()
    dev = torch.device(opts.device)
    traffic = dict(cell.traffic)
    if opts.pool_frames:
        traffic["pool_frames"] = opts.pool_frames
    cell.traffic = traffic
    _, tier = runner.tier_of(cell)
    geo = geometry(cell, opts.resolution)
    policy(cell, geo)
    frames = drive.make_frames(cell, seed, dev, opts.size)
    track = Tracking(cell, geo, frames, dev)
    schedule = drive.Schedule(1, traffic["pool_frames"], seed)
    print(f"motion per frame: {json.dumps(drive.motion_stats(frames.poses))}", flush=True)

    t_frames = time.perf_counter()
    warm = track.new()
    pool = traffic["pool_frames"]
    for f in (0, pool // 2, pool // 2 + 1):
        track.step(warm, f)
    del warm
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_fallback = time.perf_counter()
    tracker = track.new()
    frame_of, outputs, warm_ms = [], [], []

    def step(k):
        frame_of.append(int(schedule.frames(k)[0]))
        return track.step(tracker, frame_of[-1])

    for k in range(traffic["warmup_steps"]):
        ts = time.perf_counter()
        outputs.append(step(k))
        warm_ms.append((time.perf_counter() - ts) * 1e3)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    print(f"set-up: {t_frames - t_start:.3f} s to the frames, {t_fallback - t_frames:.3f} s "
          f"the throwaway tracker, {t_warm - t_fallback:.3f} s the warm-up steps", flush=True)

    first = len(outputs)
    # The window's steps run slower than the warm-up's (the gather loop's
    # frames): draw the samples over 0.7 of the steps the warm-up predicts,
    # so that every run of them lies inside the window.
    expected = int(0.7 * seconds * 1e3 / max(statistics.median(warm_ms[1:] or warm_ms), 1e-3))
    if opts.max_steps is not None:
        expected = min(expected, opts.max_steps)
    picked = set(map_check.sample_steps(first, expected, opts.samples or traffic["samples"],
                                        traffic["sample_run"], seed + 3))
    ev = map_check.Evidence(frames=frames, tier=tier, geo=geo,
                            step=cell.config["volume"]["march_step"] * geo.truncation,
                            frame_of=frame_of, outputs=outputs, first=first)

    program_peak = []

    def window_step(k):
        if k not in picked:
            return step(k)
        if not program_peak and dev.type == "cuda":
            program_peak.append(torch.cuda.max_memory_allocated(dev))
        last = ev.samples[-1] if ev.samples else None
        before = last.after if last is not None and last.step == k - 1 else tuple(
            f.clone() for f in tracker.volume)
        sample = map_check.Sample(step=k, frame=int(schedule.frames(k)[0]), before=before)
        row = step(k)
        sample.after = tuple(f.clone() for f in tracker.volume)
        sample.render = tracker.last_render
        ev.samples.append(sample)
        return row

    launches0 = level_launches()
    win = drive.run_window(window_step, first, seconds, opts.max_steps)
    outputs += win.outputs
    steps = len(win.outputs)

    record = None
    if trace_on:
        from dense_visual_odometry_torch.models import robust

        eligible = sum(robust.level_plan(track.cfg, lv).level_kernel for lv in range(tier.levels))
        record = map_trace.MapRecord(step_ms=list(win.step_ms), window_steps=steps,
                                     level_launches=level_launches() - launches0,
                                     eligible_levels=eligible,
                                     frame_pixels=int(np.prod(frames.depth.shape[1:3])))
        if dev.type == "cuda":
            reads = 0
            for _ in range(traffic["host_read_steps"]):
                reads += trace.count_host_reads(lambda: outputs.append(step(len(outputs))))
            record.host_read_steps = traffic["host_read_steps"]
            record.host_reads = reads
            ks = list(range(len(outputs), len(outputs) + traffic["profile_steps"]))
            map_trace.profile(lambda k: outputs.append(step(k)), ks, record)

    device = drive.device_info(cell.chips) if dev.type == "cuda" else {}
    if program_peak:
        device["memory_peak_with_copies_bytes"] = device["memory_peak_bytes"]
        device["memory_peak_bytes"] = program_peak[0]
    del tracker
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = map_check.judge(ev)
    window = np.stack(win.outputs)
    failed = int((~np.isfinite(window[:, :, drive.POSE]).all(axis=2)).sum())
    metrics = {"setup_s": setup_s,
               "tracked_fps": steps / win.seconds,
               "frame_ms_p50": runner.percentile(win.step_ms, 50),
               "frame_ms_p95": runner.percentile(win.step_ms, 95)}
    return runner.Outcome(attempted=steps, failed=failed, metrics=metrics, numbers=numbers,
                          record=record, notes={"device": device, "steps": steps,
                                                "window_s": win.seconds, "evidence": ev})
