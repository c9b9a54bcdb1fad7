"""Tracing and profiling hooks.

Counterpart of ``dense_visual_odometry_tpu/utils/profiling.py`` on
``torch.profiler``:

- :func:`trace_span` / :func:`annotate` mark a host-side span as a
  ``torch.profiler.record_function`` range (plus an NVTX range where CUDA
  is available), so that a trace groups the kernels launched inside it
  under the span's name;
- :func:`start_trace` / :func:`stop_trace` capture one trace (host and, on a
  GPU, device activity) and write it as ``trace.json`` (Chrome trace format)
  into the directory given;
- :class:`WallClock` aggregates host-side phase timings with counts and
  percentiles;
- :func:`device_memory_stats` reads the GPU allocator's statistics.

The spans cost a profiler range each (nothing recorded while no profiler
runs); WallClock is a dict of floats.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch


class _Trace:
    """The one trace :func:`start_trace` opened, until :func:`stop_trace`."""

    profiler: Optional[torch.profiler.profile] = None
    log_dir: Optional[Path] = None


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """Mark a host-side span so that the kernels launched inside it are
    grouped under ``name`` in a trace."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def annotate(name: str):
    """Decorator form of :func:`trace_span`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with trace_span(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def start_trace(log_dir) -> None:
    """Begin capturing a trace: host activity, and the device's where CUDA
    is available.  One trace at a time."""
    if _Trace.profiler is not None:
        raise RuntimeError("a trace is already running; stop_trace() it first")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    _Trace.profiler, _Trace.log_dir = profiler, Path(log_dir)


def stop_trace() -> Path:
    """End the trace and write it to ``<log_dir>/trace.json`` -> that path."""
    profiler, log_dir = _Trace.profiler, _Trace.log_dir
    if profiler is None:
        raise RuntimeError("no trace is running; start_trace() first")
    _Trace.profiler = _Trace.log_dir = None
    profiler.stop()
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / "trace.json"
    profiler.export_chrome_trace(str(path))
    return path


class WallClock:
    """Host-side phase timing accumulator.

    >>> clock = WallClock()
    >>> with clock.span("track"):
    ...     pose = session.step(rgb, depth)
    >>> clock.summary()["track"]["mean_ms"]
    """

    def __init__(self) -> None:
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self, skip_first: bool = True) -> Dict[str, Dict[str, float]]:
        """Per-phase stats; ``skip_first`` drops the warm-up sample when more
        than one exists."""
        out = {}
        for name, xs in self._samples.items():
            steady = xs[1:] if (skip_first and len(xs) > 1) else xs
            steady_sorted = sorted(steady)
            n = len(steady_sorted)
            out[name] = {
                "count": float(len(xs)),
                "total_s": float(sum(xs)),
                "mean_ms": 1e3 * sum(steady) / n,
                "p50_ms": 1e3 * steady_sorted[n // 2],
                "p95_ms": 1e3 * steady_sorted[min(n - 1, int(0.95 * n))],
                "max_ms": 1e3 * steady_sorted[-1],
            }
        return out


def device_memory_stats(device=None) -> Optional[dict]:
    """The GPU allocator's statistics (``torch.cuda.memory_stats``) with the
    JAX package's names for the three it reads (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit``), or None without a GPU."""
    if not torch.cuda.is_available():
        return None
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
    stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak", 0)
    stats["bytes_limit"] = torch.cuda.get_device_properties(device or 0).total_memory
    return stats
