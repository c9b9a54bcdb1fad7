"""Tracing and profiling hooks.

- The tracer: :func:`enable_tracing` / :func:`disable_tracing` switch it
  (off by default); :func:`trace_span` records a span of host time at one of
  the program's layer boundaries, :func:`count` adds to a counter, and
  :func:`drain` returns and clears what was recorded, with the kernel
  wrappers' launch counters beside the program's own.
- :func:`start_trace` / :func:`stop_trace` capture one ``torch.profiler``
  trace (host and, on a GPU, device activity) and write it as
  ``trace.json`` (Chrome trace format) into the directory given.
- :func:`device_memory_stats` reads the GPU allocator's statistics.

Off, :func:`trace_span` returns one shared no-op context manager after a
single flag check, and :func:`count` is that check alone.  On, a span keeps
its name, start and end, its parent, the id of the step it belongs to (a
span opened with no span open starts a step: every span under a
``session.step`` shares its id) and its attributes (``level``, ``path``,
``retrack``, ``streams``).  Start and end are ``time.time_ns()``, the clock
of ``torch.profiler``'s events, so a span lies directly over the device
trace; while a profiler runs, each span is also a ``record_function`` range
of the same name.  Spans are kept in memory, at most :data:`MAX_SPANS`
between drains; the rest are counted in ``spans.dropped``.

The tracer is one per process and serves one thread: the sessions step on
the caller's thread.
"""

from __future__ import annotations

import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import torch

MAX_SPANS = 1 << 18

_on = False


class _NoSpan:
    """What :func:`trace_span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, level=None, path=None, retrack=None, streams=None):
        pass


_NO_SPAN = _NoSpan()


class _Recorder:
    """The spans, counters and open-span stack of the running tracer."""

    def __init__(self) -> None:
        self.spans: List["_Span"] = []
        self.stack: List["_Span"] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self.next_id = 0
        self.next_step = 0
        self.launches0: Dict[str, int] = {}


_rec = _Recorder()


class _Span:
    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "step", "level", "path",
                 "retrack", "streams", "_range")

    def __init__(self, name, level, path, retrack, streams):
        self.name, self.level, self.path = name, level, path
        self.retrack, self.streams = retrack, streams
        self.end_ns = None
        self._range = None

    def set(self, level=None, path=None, retrack=None, streams=None):
        """Attributes known only once the span is open."""
        if level is not None:
            self.level = level
        if path is not None:
            self.path = path
        if retrack is not None:
            self.retrack = retrack
        if streams is not None:
            self.streams = streams

    def __enter__(self):
        rec = _rec
        parent = rec.stack[-1] if rec.stack else None
        self.id, rec.next_id = rec.next_id, rec.next_id + 1
        if parent is None:
            self.parent, self.step = None, rec.next_step
            rec.next_step += 1
        else:
            self.parent, self.step = parent.id, parent.step
        rec.stack.append(self)
        if len(rec.spans) < MAX_SPANS:
            rec.spans.append(self)
        else:
            rec.counters["spans.dropped"] += 1
        self.start_ns = time.time_ns()
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = time.time_ns()
        if _rec.stack and _rec.stack[-1] is self:
            _rec.stack.pop()
        return False

    def as_dict(self) -> dict:
        out = {"id": self.id, "name": self.name, "start_ns": self.start_ns,
               "end_ns": self.end_ns, "parent": self.parent, "step": self.step}
        for key in ("level", "path", "retrack", "streams"):
            value = getattr(self, key)
            if value is not None:
                out[key] = value
        return out


def trace_span(name: str, level=None, path=None, retrack=None, streams=None):
    """A context manager around one span of host time named ``name`` (with
    tracing off, a shared one that records nothing); ``.set(...)`` adds an
    attribute once the span is open."""
    if not _on:
        return _NO_SPAN
    return _Span(name, level, path, retrack, streams)


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to counter ``name`` while tracing is on."""
    if _on:
        _rec.counters[name] += n


def tracing() -> bool:
    """Whether the tracer records: a value that is costly to compute for a
    counter is computed only then."""
    return _on


def _launches() -> Dict[str, int]:
    # The tracker imports the kernel wrappers in an order free of import cycles.
    from dense_visual_odometry_torch.models import robust  # noqa: F401
    from dense_visual_odometry_torch.ops.cuda import (
        fused_iter,
        level_solver,
        pyramid,
        stackwarp,
        tsdf,
    )

    return {"lm_level.launches": level_solver.lm_level.launches,
            "fused_evaluation.launches": fused_iter.fused_evaluation.launches,
            "stack_accumulate.launches": stackwarp.stack_accumulate.launches,
            "median_pyr_down.launches": pyramid.median_pyr_down.launches,
            "integrate_volume.launches": tsdf.integrate_volume.launches}


def enable_tracing() -> None:
    """Start recording spans and counters (the launch counters are reported
    from here on, as the change since this call or the last drain)."""
    global _on
    if not _on:
        _rec.launches0 = _launches()
    _on = True


def disable_tracing() -> None:
    """Stop recording; what was recorded stays until :func:`drain`."""
    global _on
    _on = False


def drain() -> dict:
    """-> ``{"spans": [...], "counters": {...}}`` recorded since the last
    drain, and clear them.  Each span is a dict: ``id``, ``name``,
    ``start_ns``, ``end_ns``, ``parent`` (an id or None), ``step``, and the
    attributes it was given; a span still open stays for the next drain.
    The counters hold ``spans.dropped`` and the kernel wrappers' launches
    (``lm_level.launches``, ``fused_evaluation.launches``,
    ``stack_accumulate.launches``, ``median_pyr_down.launches``) since
    tracing was enabled or last drained."""
    rec = _rec
    spans = [s.as_dict() for s in rec.spans if s.end_ns is not None]
    counters = dict(rec.counters)
    counters.setdefault("spans.dropped", 0)
    now = _launches()
    for key, value in now.items():
        counters[key] = value - rec.launches0.get(key, value)
    rec.spans = [s for s in rec.spans if s.end_ns is None]
    rec.counters = defaultdict(int)
    rec.launches0 = now
    return {"spans": spans, "counters": counters}


class _Trace:
    """The one trace :func:`start_trace` opened, until :func:`stop_trace`."""

    profiler: Optional[torch.profiler.profile] = None
    log_dir: Optional[Path] = None


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
