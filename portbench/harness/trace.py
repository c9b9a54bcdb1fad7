"""The traced run's record: what the per-layer readers under ``metrics/``
read.

A traced run counts the tracker's synchronising host reads over a few
steps (``torch.cuda.set_sync_debug_mode("warn")``, as ``chip_smoke.py``'s
``host_reads`` does), then profiles a few more with ``torch.profiler``
(CPU and CUDA, with Python stacks), keeping the events in memory; no trace
file is written.  Each profiled step leaves the level kernel's bound for
that step (``roofline.level_step_bound_ms``: the cell's shapes and the
step's ``TrackResult.diagnostics``), or None where the step sent a level
that the tier gives the level kernel elsewhere.  The record also holds the
benchmark's own step spans of the measured window and the port's launch
counters over it.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

OWN_KERNELS = ("level_kernel", "fused_kernel", "stack_kernel")
STEP_SPAN = "portbench.step"


@dataclass
class Record:
    """Everything a per-layer reader may read."""

    step_ms: List[float]  # the measured window's steps, host clock
    window_steps: int
    level_launches: int  # level-kernel launches over the window
    eligible_levels: int  # levels that the configuration sends to the level kernel
    host_read_steps: int = 0
    host_reads: int = 0
    profiled_steps: int = 0
    window_us: float = 0.0  # the profiled steps, first start to last end
    device: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, start us, end us)
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host frame, us)
    steps: List[Tuple[float, float]] = field(default_factory=list)  # profiled steps' spans, us
    level_bound_ms: List[Optional[float]] = field(default_factory=list)  # per profiled step


def count_host_reads(step: Callable[[], object]) -> int:
    """Synchronising device-to-host reads that ``step()`` makes."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, cursor = [], lo
    for a, b in sorted(intervals):
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


def _frame_name(frame: str) -> str:
    """``.../models/robust.py(955): _solve_level`` -> ``robust._solve_level``."""
    path, _, func = frame.partition(": ")
    module = path.rsplit("/", 1)[-1].split("(")[0].removesuffix(".py")
    return f"{module}.{func}" if func else frame


def host_frame(cpu: List[tuple], t: float) -> str:
    """What the host ran at ``t``: the innermost aten op running then, else
    the last one that ended before it, with the innermost frame of the
    port's ``models/`` (else of the port) in its Python stack."""
    ops = [c for c in cpu if c[0].startswith("aten::")]
    covering = [c for c in ops if c[1] <= t <= c[2]]
    if covering:
        name, _, _, stack = max(covering, key=lambda c: c[1])
    else:
        before = [c for c in ops if c[2] < t]
        if not before:
            return "host"
        name, _, _, stack = max(before, key=lambda c: c[2])
    port = ([f for f in stack if "dense_visual_odometry_torch/models/" in f]
            or [f for f in stack if "dense_visual_odometry_torch" in f])
    return f"{_frame_name(port[0])} > {name}" if port else name


def profile_steps(steps: Callable[[int], object], ks: List[int], record: Record) -> list:
    """Profile ``steps(k)`` for each ``k`` into ``record``; -> what each
    call returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    returned = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        for k in ks:
            with record_function(STEP_SPAN):
                returned.append(steps(k))
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    device, cpu, step_spans = [], [], []
    for e in events:
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        on_device = e.device_type() == DeviceType.CUDA
        if e.name() == STEP_SPAN:
            if not on_device:
                step_spans.append((a, b))
        elif on_device:
            # Annotations (this harness's span) mirror host ranges on the
            # device's timeline; they are no device work.
            if not e.is_user_annotation():
                device.append((e.name(), a, b))
        else:
            cpu.append((e.name(), a, b, list(e.stack())))
    step_spans.sort()
    lo = step_spans[0][0]
    hi = max(b for _, b in step_spans)
    device = [(n, a, b) for n, a, b in device if b > lo and a < hi]
    record.profiled_steps = len(ks)
    record.window_us = hi - lo
    record.device = device
    record.steps = step_spans
    gaps = idle_gaps([(a, b) for _, a, b in device], lo, hi)
    gaps.sort(key=lambda g: g[0] - g[1])
    record.gaps = [(host_frame(cpu, (a + b) / 2), b - a) for a, b in gaps[:10]]
    return returned


def busy_us(record: Record) -> float:
    return union_us([(a, b) for _, a, b in record.device])


def breakdown(record: Record) -> dict:
    """The device operations that took the most time and the longest idle
    gaps, in seconds."""
    by_name: Dict[str, float] = {}
    for n, a, b in record.device:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], t / 1e6] for n, t in ops],
            "idle_gaps": [[n[:200], t / 1e6] for n, t in record.gaps[:10]]}
