"""One run of a cell whose entry tracks streams on one device.

The entry module supplies an adapter (the session, one step, the state's
pyramids); this module does the rest in the same order for every such
cell: set-up (frames on the device, the tracker's fallback path warmed on a
throwaway session, the cell's own session warmed by a few steps), the
measured window, with ``--trace 1`` the host-read count and the profiled
steps, then the memory peak, the state sample, and the judgement.
"""

from __future__ import annotations

import json
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import roofline
from portbench.harness import check, drive, trace
from portbench.harness.cell import Cell


@dataclass
class Options:
    """What a test may change; a benchmark run takes the defaults."""

    device: str = "cuda"
    size: Optional[tuple] = None  # (H, W) instead of the configuration's
    streams: Optional[int] = None
    pool_frames: Optional[int] = None
    max_steps: Optional[int] = None  # end the window after this many steps


@dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: Dict[str, float]
    numbers: Dict[str, float]
    record: Optional[trace.Record] = None
    notes: Dict[str, object] = field(default_factory=dict)


def tier_of(cell: Cell):
    path = cell.root / cell.config["tracker_config"]
    with path.open() as fp:
        return path, check.Tier.from_json(json.load(fp))


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by ``statistics.quantiles`` (inclusive), q in 1..99."""
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=100, method="inclusive")[int(q) - 1])


def level_bound(diag, size, tier, kernel_levels) -> float:
    """A step's level-kernel bound (ms) from its ``TrackResult.diagnostics``,
    stacked coarse to fine."""
    counts = diag.count.double().cpu().flip(0).tolist()
    its = diag.iterations.double().cpu().flip(0).tolist()
    return roofline.level_step_bound_ms(size, tier.strides, kernel_levels, counts, its)


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool, t_start: float,
             adapter_factory: Callable, opts: Options) -> Outcome:
    from dense_visual_odometry_torch.models import robust

    dev = torch.device(opts.device)
    traffic = dict(cell.traffic)
    if opts.pool_frames:
        traffic["pool_frames"] = opts.pool_frames
    cell.traffic = traffic
    streams = opts.streams or traffic["streams"]
    tier_path, tier = tier_of(cell)
    frames = drive.make_frames(cell, seed, dev, opts.size)
    schedule = drive.Schedule(streams, traffic["pool_frames"], seed)
    adapter = adapter_factory(cell, tier_path, frames, schedule, streams, dev)
    stats = drive.motion_stats(frames.poses)
    print(f"motion per frame: {json.dumps(stats)}", flush=True)

    t_frames = time.perf_counter()
    adapter.warm_fallback()
    t_fallback = time.perf_counter()
    session = adapter.new_session()
    outputs = [adapter.step(session, k) for k in range(traffic["warmup_steps"])]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    print(f"set-up: {t_frames - t_start:.3f} s to the frames, {t_fallback - t_frames:.3f} s "
          f"the fallback's warm-up, {t_warm - t_fallback:.3f} s the warm-up steps", flush=True)

    launches0 = adapter.level_launches()
    win = drive.run_window(lambda k: adapter.step(session, k), len(outputs), seconds,
                           opts.max_steps)
    first = len(outputs)
    outputs += win.outputs
    steps = len(win.outputs)
    record = None
    if trace_on:
        eligible = sum(robust.level_plan(adapter.cfg, lv).level_kernel for lv in range(tier.levels))
        record = trace.Record(step_ms=list(win.step_ms), window_steps=steps,
                              level_launches=adapter.level_launches() - launches0,
                              eligible_levels=eligible)
        if dev.type == "cuda":
            start, reads = len(outputs), 0
            for k in range(start, start + traffic["host_read_steps"]):
                reads += trace.count_host_reads(lambda: outputs.append(adapter.step(session, k)))
            record.host_read_steps = traffic["host_read_steps"]
            record.host_reads = reads
            ks = list(range(len(outputs), len(outputs) + traffic["profile_steps"]))
            kernel_levels = [lv for lv in range(tier.levels)
                             if robust.level_plan(adapter.cfg, lv).level_kernel]

            def traced(k):
                """The step's diagnostics where every level the tier gives
                the level kernel ran on it, once."""
                n0 = adapter.level_launches()
                outputs.append(adapter.step(session, k))
                if not kernel_levels or adapter.level_launches() - n0 != len(kernel_levels):
                    return None
                return session.last_output.result.diagnostics

            diags = trace.profile_steps(traced, ks, record)
            size = tuple(frames.rgb.shape[1:3])
            record.level_bound_ms = [None if d is None else level_bound(d, size, tier, kernel_levels)
                                     for d in diags]

    peak = drive.device_info(cell.chips) if dev.type == "cuda" else {}
    rng = np.random.default_rng(seed + 2)
    state_streams = sorted(rng.choice(streams, size=min(streams, traffic["state_streams"]),
                                      replace=False).tolist())
    gray, depth = adapter.state_pyramids(session, state_streams)
    del session
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.judge(frames, tier, schedule, outputs, first, traffic["check_pairs"],
                          seed + 1, state_streams, gray, depth)
    window = np.stack(win.outputs)
    failed = int((~np.isfinite(window[:, :, drive.POSE]).all(axis=2)).sum())
    metrics = {"setup_s": setup_s,
               "tracked_fps": streams * steps / win.seconds,
               "frame_ms_p50": percentile(win.step_ms, 50),
               "frame_ms_p95": percentile(win.step_ms, 95)}
    return Outcome(attempted=streams * steps, failed=failed, metrics=metrics, numbers=numbers,
                   record=record, notes={"device": peak, "steps": steps,
                                         "window_s": win.seconds, "motion": stats,
                                         "evidence": (frames, tier, schedule, outputs, first)})
