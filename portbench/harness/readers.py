"""What the per-layer metric files under ``metrics/`` compute from a
traced run's ``trace.Record``; each returns None where the record holds
nothing to read, and the metric is then left out of the line."""

from __future__ import annotations

import statistics
from typing import Optional

from portbench.harness.trace import OWN_KERNELS, Record, busy_us


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def step_ms_p50(rec: Record) -> Optional[float]:
    return float(statistics.median(rec.step_ms)) if rec.step_ms else None


def level_kernel_share(rec: Record) -> Optional[float]:
    """Level-kernel launches over the levels the tier sends to it, in %."""
    if not rec.eligible_levels or not rec.window_steps:
        return None
    return 100.0 * rec.level_launches / (rec.eligible_levels * rec.window_steps)


def host_reads(rec: Record) -> Optional[float]:
    return rec.host_reads / rec.host_read_steps if rec.host_read_steps else None


def glue_kernels(rec: Record) -> Optional[float]:
    """Device kernels a step that are not the port's own three."""
    if not rec.profiled_steps:
        return None
    n = sum(1 for name, _, _ in rec.device
            if is_kernel(name) and not any(k in name for k in OWN_KERNELS))
    return n / rec.profiled_steps


def level_roofline(rec: Record) -> Optional[float]:
    """The level kernel's bound over its device time, in %, over the
    profiled steps that kept every level the tier gives it on it (each
    step's kernels run inside its span: the step ends on a host read)."""
    bound_ms = spent_us = 0.0
    for (lo, hi), step_bound in zip(rec.steps, rec.level_bound_ms):
        if step_bound is None:
            continue
        bound_ms += step_bound
        spent_us += sum(b - a for name, a, b in rec.device
                        if "level_kernel" in name and lo <= a < hi)
    if spent_us <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms / (spent_us / 1e3)


def idle_pct(rec: Record) -> Optional[float]:
    if rec.window_us <= 0:
        return None
    return 100.0 * (1.0 - busy_us(rec) / rec.window_us)
