"""The port's own tracer in a traced run, and what the readers of its
per-layer metrics compute from it.

The port records spans and counters while its tracer is on
(``dense_visual_odometry_torch.utils.profiling``: ``enable_tracing``,
``drain``).  A :class:`SpanRecord` is a ``trace.Record`` with what the
tracer gave over a traced stretch of steps (``spans``, ``counters``) and,
for each device operation of the profiled steps, the host time of the call
that launched it (``launch_us``, matched by the launch's correlation id).
Spans are stamped on the profiler's clock (``time.time_ns()``), so a span
and a device operation compare directly.

Each reader returns None where the record holds nothing to read, and where
the tracer dropped spans.  ``traced.py`` fills a record on the card; the
metric files under ``metrics/`` can call these readers once the runner
fills the same fields.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from portbench.harness.trace import Record, idle_gaps

STEP_ROOT = "session.step"
UPLOAD = "frame.upload"
PYRAMID = "frame.pyramid"
SYNC = "sync."
NO_SPAN = "(no span)"


@dataclass
class SpanRecord(Record):
    spans: List[dict] = field(default_factory=list)  # the tracer's, as ``drain()`` gives them
    counters: Dict[str, int] = field(default_factory=dict)
    launch_us: List[Optional[float]] = field(default_factory=list)  # per ``device`` entry


def _sound(rec) -> bool:
    return bool(rec.spans) and not rec.counters.get("spans.dropped", 0)


def per_step_ms(rec, match) -> List[float]:
    """For each step of the tracer (a ``session.step`` root), the summed
    duration (ms) of its spans whose name ``match`` accepts."""
    steps = {s["step"]: 0.0 for s in rec.spans if s["name"] == STEP_ROOT and s["parent"] is None}
    for s in rec.spans:
        if s["step"] in steps and match(s["name"]):
            steps[s["step"]] += (s["end_ns"] - s["start_ns"]) / 1e6
    return list(steps.values())


def _median_per_step(rec, match) -> Optional[float]:
    if not _sound(rec):
        return None
    values = per_step_ms(rec, match)
    return float(statistics.median(values)) if values else None


def upload_ms_p50(rec) -> Optional[float]:
    """Median over the steps of the time a step spends in ``frame.upload``."""
    return _median_per_step(rec, lambda name: name == UPLOAD)


def host_wait_ms_p50(rec) -> Optional[float]:
    """Median over the steps of the summed ``sync.*`` spans: the host's
    waits on the device's answer."""
    return _median_per_step(rec, lambda name: name.startswith(SYNC))


def retrack_pct(rec) -> Optional[float]:
    """Steps that ran a second cascade, in % of the steps traced."""
    if not _sound(rec):
        return None
    steps = sum(1 for s in rec.spans if s["name"] == STEP_ROOT and s["parent"] is None)
    if not steps:
        return None
    return 100.0 * rec.counters.get("retracks", 0) / steps


def fallback_unneeded_pct(rec) -> Optional[float]:
    """Of the stream-levels solved on the gather path, the share whose own
    result did not need it, in %: 100 x (1 - gather_kept / gather)."""
    if not _sound(rec):
        return None
    gather = rec.counters.get("stream_levels.gather", 0)
    if not gather:
        return None
    return 100.0 * (1.0 - rec.counters.get("stream_levels.gather_kept", 0) / gather)


def intervals_us(rec, name) -> List[Tuple[float, float]]:
    return sorted((s["start_ns"] / 1e3, s["end_ns"] / 1e3) for s in rec.spans if s["name"] == name)


def _inside(intervals: List[Tuple[float, float]], t: float) -> bool:
    return any(a <= t <= b for a, b in intervals)


def launched_in_us(rec, name) -> Optional[float]:
    """Device time (us, summed) over the profiled steps of the operations
    whose launch the host made inside a span named ``name``."""
    if (not _sound(rec) or not rec.profiled_steps or not rec.steps or not rec.device
            or len(rec.launch_us) != len(rec.device)):
        return None
    lo, hi = min(a for a, _ in rec.steps), max(b for _, b in rec.steps)
    intervals = [(a, b) for a, b in intervals_us(rec, name) if b >= lo and a <= hi]
    if not intervals:
        return None
    return sum(b - a for (_, a, b), t in zip(rec.device, rec.launch_us)
               if t is not None and _inside(intervals, t))


def pyramid_ms(rec) -> Optional[float]:
    """Device ms a profiled step of the kernels launched inside
    ``frame.pyramid``."""
    spent = launched_in_us(rec, PYRAMID)
    return None if spent is None else spent / 1e3 / rec.profiled_steps


def _label(span: dict) -> str:
    return f"{span['name']}[{span['path']}]" if "path" in span else span["name"]


def self_intervals(spans: List[dict]) -> List[Tuple[float, float, str]]:
    """Host time cut by the innermost span open: (start us, end us, label)
    pieces, disjoint and sorted.  A span's piece is its interval less its
    children's."""
    kids: Dict[int, List[Tuple[float, float]]] = {}
    for s in spans:
        if s["parent"] is not None:
            kids.setdefault(s["parent"], []).append((s["start_ns"] / 1e3, s["end_ns"] / 1e3))
    pieces = []
    for s in spans:
        lo, hi = s["start_ns"] / 1e3, s["end_ns"] / 1e3
        for a, b in idle_gaps(kids.get(s["id"], []), lo, hi):
            pieces.append((a, b, _label(s)))
    pieces.sort()
    return pieces


def idle_by_span(rec) -> Optional[List[Tuple[str, float, float]]]:
    """Each idle gap of the device over the profiled steps credited to the
    innermost program span open on the host over it, split where the host
    moved between spans: [(label, idle ms a step, share of the idle in %)],
    largest first.  ``track.level`` carries its path in the label."""
    if not _sound(rec) or not rec.profiled_steps or not rec.steps:
        return None
    busy = [(a, b) for _, a, b in rec.device]
    gaps = sorted(g for lo, hi in rec.steps for g in idle_gaps(busy, lo, hi))
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return None
    lo, hi = gaps[0][0], gaps[-1][1]
    window = [s for s in rec.spans if s["end_ns"] / 1e3 >= lo and s["start_ns"] / 1e3 <= hi]
    pieces = self_intervals(window)
    credit: Dict[str, float] = {NO_SPAN: 0.0}
    i = 0
    for a, b in gaps:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        covered, j = 0.0, i
        while j < len(pieces) and pieces[j][0] < b:
            part = min(b, pieces[j][1]) - max(a, pieces[j][0])
            if part > 0:
                credit[pieces[j][2]] = credit.get(pieces[j][2], 0.0) + part
                covered += part
            j += 1
        credit[NO_SPAN] += (b - a) - covered
    rows = [(label, us / 1e3 / rec.profiled_steps, 100.0 * us / total)
            for label, us in credit.items() if us > 0]
    return sorted(rows, key=lambda r: -r[1])


def idle_table(rows: List[Tuple[str, float, float]]) -> str:
    """The idle-by-span table as text."""
    lines = ["idle by span (innermost span open on the host; ms a step, % of idle):"]
    lines += [f"  {label:<40} {ms:10.3f} ms {pct:6.1f}%" for label, ms, pct in rows]
    return "\n".join(lines)
