"""A KinectFusion cell's traced steps, and what its mapping metrics read.

``profile`` runs a few steps under ``torch.profiler`` (CPU and CUDA, with
Python stacks) with the port's tracer on, and fills a :class:`MapRecord`:
``trace.Record``'s fields (the device operations, the steps' spans, the
longest idle gaps by what the host ran), the tracer's spans and counters,
and each device operation's launch time on the host (``launch_us``,
matched by correlation id), so that an operation is credited to the span in
which the host launched it.

The readers return None where the record holds nothing to read: no spans
(a port without the tracer or without the mapping spans), dropped spans,
or no operation launched in the span.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from portbench import roofline_map
from portbench.harness import spans, trace
from portbench.harness.readers import is_kernel

RENDER = "map.render"
FUSE = "map.fuse"


@dataclass
class MapRecord(spans.SpanRecord):
    frame_pixels: int = 0  # pixels of a frame the fusion reads


def profile(step: Callable[[int], object], ks: List[int], record: MapRecord) -> None:
    """Profile ``step(k)`` for each ``k`` into ``record`` with the port's
    tracer on (where the port has one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    from dense_visual_odometry_torch.utils import profiling

    tracer = hasattr(profiling, "enable_tracing")
    if tracer:
        profiling.drain()
        profiling.enable_tracing()
    try:
        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                    with_stack=True) as prof:
            for k in ks:
                with record_function(trace.STEP_SPAN):
                    step(k)
            torch.cuda.synchronize()
    finally:
        if tracer:
            profiling.disable_tracing()
    if tracer:
        drained = profiling.drain()
        record.spans, record.counters = drained["spans"], drained["counters"]
    device, cpu, steps, host_by_corr = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), a, b, e.correlation_id()))
        elif e.name() == trace.STEP_SPAN:
            steps.append((a, b))
        else:
            if e.name().startswith("cu") and e.correlation_id():
                host_by_corr[e.correlation_id()] = a
            cpu.append((e.name(), a, b, list(e.stack())))
    steps.sort()
    lo, hi = steps[0][0], max(b for _, b in steps)
    device = [d for d in device if d[2] > lo and d[1] < hi]
    record.profiled_steps = len(ks)
    record.window_us = hi - lo
    record.steps = steps
    record.device = [d[:3] for d in device]
    record.launch_us = [host_by_corr.get(d[3]) for d in device]
    gaps = trace.idle_gaps([(a, b) for _, a, b, _ in device], lo, hi)
    gaps.sort(key=lambda g: g[0] - g[1])
    record.gaps = [(trace.host_frame(cpu, (a + b) / 2), b - a) for a, b in gaps[:10]]


def _per_step(rec, name: str, kernels_only: bool) -> Optional[List[float]]:
    """For each profiled step, the device time (us) of the operations the
    host launched inside spans named ``name`` (their count with
    ``kernels_only``)."""
    launch_us = getattr(rec, "launch_us", None)  # a record of the tracer's, or none
    if (launch_us is None or not spans._sound(rec) or not rec.steps or not rec.device
            or len(launch_us) != len(rec.device)):
        return None
    named = spans.intervals_us(rec, name)
    out, found = [], False
    for lo, hi in rec.steps:
        inside = [(a, b) for a, b in named if a >= lo and b <= hi]
        total = 0.0
        for (op, a, b), t in zip(rec.device, rec.launch_us):
            if t is None or not any(x <= t <= y for x, y in inside):
                continue
            if kernels_only:
                total += is_kernel(op)
            else:
                total += b - a
            found = True
        out.append(total)
    return out if found else None


def render_ms_p50(rec) -> Optional[float]:
    """Median over the profiled steps of the device time (ms) of the
    operations launched inside ``map.render``."""
    v = _per_step(rec, RENDER, False)
    return None if v is None else statistics.median(v) / 1e3


def fuse_ms_p50(rec) -> Optional[float]:
    v = _per_step(rec, FUSE, False)
    return None if v is None else statistics.median(v) / 1e3


def render_kernels(rec) -> Optional[float]:
    """Median over the profiled steps of the device kernels launched inside
    ``map.render``."""
    v = _per_step(rec, RENDER, True)
    return None if v is None else float(statistics.median(v))


def fuse_roofline(rec) -> Optional[float]:
    """The fusions' bound over their device time, in %, over the profiled
    steps: ``roofline_map.fuse_bound_ms`` of the voxels they visited
    (``map.voxels_fused``) and the frames they read (``map.fused``)."""
    v = _per_step(rec, FUSE, False)
    if v is None or sum(v) <= 0:
        return None
    voxels = rec.counters.get("map.voxels_fused", 0)
    passes = rec.counters.get("map.fused", 0)
    if not voxels or not passes or not getattr(rec, "frame_pixels", 0):
        return None
    return 100.0 * roofline_map.fuse_bound_ms(voxels, rec.frame_pixels, passes) / (sum(v) / 1e3)
