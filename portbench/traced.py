"""Run one cell's steps with the port's tracer on, and print what its spans
and counters read.

    python3 portbench/traced.py --workload <cell> --seed <n> [--blocks 3] [--block-seconds 5]

from the root of a checkout on a machine with the cards the cell asks for.
The set-up is the benchmark's (``harness/runner.py``: the cell's frames on
the card, the fallback's warm-up, the session's warm-up steps).  Then:

- ``--blocks`` pairs of blocks of ``--block-seconds`` each, one with the
  tracer off and one with it on, in turns (off first in even pairs): the
  tracer's cost is the on blocks' median step against the off blocks';
  what the tracer records in the on blocks is what the window readers
  read;
- the cell's ``host_read_steps`` steps, each run twice from the same
  session state, with the tracer off and then on: the synchronising host
  reads of each (``set_sync_debug_mode``), and whether the two returned
  the same poses bit for bit;
- the cell's ``profile_steps`` steps under ``torch.profiler`` with the
  tracer on, each device operation credited to the host time of the call
  that launched it (its correlation id): the device time launched inside
  ``frame.pyramid``, the idle gaps by the innermost span open on the host,
  and the program's spans against the profiler's ranges of the same names.

The last line of standard output is one JSON object; standard error ends
with the idle-by-span table.  The benchmark's own runs (``run.py``) never
switch the tracer on.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run as bench_run  # noqa: E402

READERS = ("upload_ms_p50", "host_wait_ms_p50", "retrack_pct", "fallback_unneeded_pct")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--block-seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at --size")
    ap.add_argument("--size", type=int, nargs=2, default=None, metavar=("H", "W"))
    ap.add_argument("--streams", type=int, default=None)
    return ap.parse_args(argv)


def block(step, seconds: float) -> list:
    """Steps until ``seconds`` have passed -> each step's host-clock ms."""
    out, t0 = [], time.perf_counter()
    while True:
        ts = time.perf_counter()
        step()
        te = time.perf_counter()
        out.append((te - ts) * 1e3)
        if te - t0 >= seconds:
            return out


def profile_with_launches(step, n: int, cuda: bool):
    """``n`` steps under ``torch.profiler`` -> (device operations (name,
    start us, end us), each one's launch time on the host (us) or None, the
    steps' spans (us), the program's ranges by name [(start us, end us)])."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.harness import trace

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(n):
            with record_function(trace.STEP_SPAN):
                step()
        if cuda:
            torch.cuda.synchronize()
    device, host_by_corr, steps, ranges = [], {}, [], {}
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), a, b, e.correlation_id()))
        elif e.name() == trace.STEP_SPAN:
            steps.append((a, b))
        else:
            # The CUDA API's calls (`cuda*`, `cu*`) carry the launch's id.
            if e.name().startswith("cu") and e.correlation_id():
                host_by_corr[e.correlation_id()] = a
            ranges.setdefault(e.name(), []).append((a, b))
    steps.sort()
    lo, hi = steps[0][0], max(b for _, b in steps)
    device = [d for d in device if d[2] > lo and d[1] < hi]
    launch = [host_by_corr.get(c) for *_, c in device]
    return [d[:3] for d in device], launch, steps, ranges


def clock_check(spans: list, ranges: dict) -> dict:
    """The program's spans against the profiler's ranges of the same name,
    matched in order: the largest gaps of start and end (us)."""
    worst = {"start_us": 0.0, "end_us": 0.0, "matched": 0, "unmatched_names": []}
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append((s["start_ns"] / 1e3, s["end_ns"] / 1e3))
    for name, ours in by_name.items():
        theirs = sorted(ranges.get(name, []))
        if len(theirs) != len(ours):
            worst["unmatched_names"].append(name)
            continue
        for (a, b), (c, d) in zip(sorted(ours), theirs):
            worst["start_us"] = max(worst["start_us"], abs(a - c))
            worst["end_us"] = max(worst["end_us"], abs(b - d))
            worst["matched"] += 1
    return worst


def host_breakdown(rec) -> dict:
    """Host time a step by the innermost span open (ms, mean over the
    traced steps), and the steps' host-clock ms with and without a level
    off the level kernel."""
    from portbench.harness import spans

    roots = {s["step"]: s for s in rec.spans
             if s["name"] == spans.STEP_ROOT and s["parent"] is None}
    self_ms = {}
    for a, b, label in spans.self_intervals([s for s in rec.spans if s["step"] in roots]):
        self_ms[label] = self_ms.get(label, 0.0) + (b - a) / 1e3 / max(len(roots), 1)
    off_kernel = {s["step"] for s in rec.spans
                  if s["name"] == "track.level" and s.get("path") != "kernel"}
    groups = {"off_kernel": [], "kernel_only": []}
    for step, root in roots.items():
        ms = (root["end_ns"] - root["start_ns"]) / 1e6
        groups["off_kernel" if step in off_kernel else "kernel_only"].append(ms)
    steps = {}
    for name, ms in groups.items():
        if ms:
            q = statistics.quantiles(ms, n=20, method="inclusive") if len(ms) > 1 else ms * 19
            steps[name] = {"steps": len(ms), "p50_ms": statistics.median(ms), "p95_ms": q[18]}
    return {"self_ms": dict(sorted(self_ms.items(), key=lambda kv: -kv[1])), "steps": steps}


def main(argv=None) -> int:
    args = parse(argv)
    bench_run.set_environment()
    import numpy as np
    import torch

    from dense_visual_odometry_torch.utils import profiling
    from portbench.harness import drive, runner, spans, trace
    from portbench.harness.cell import load_cell
    from portbench.roofline import power_limit

    cell = load_cell(args.workload, ROOT)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        print(f"traced: {args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    if not hasattr(profiling, "enable_tracing"):
        print("traced: this checkout's port has no tracer", file=sys.stderr)
        return 2
    card = power_limit() if cuda else "cpu"
    traffic = cell.traffic
    streams = args.streams or traffic["streams"]
    tier_path, _ = runner.tier_of(cell)
    frames = drive.make_frames(cell, args.seed, dev, tuple(args.size) if args.size else None)
    schedule = drive.Schedule(streams, traffic["pool_frames"], args.seed)
    adapter = cell.entry().Adapter(cell, tier_path, frames, schedule, streams, dev)
    adapter.warm_fallback()
    session = adapter.new_session()
    counter = [0]

    def step():
        out = adapter.step(session, counter[0])
        counter[0] += 1
        return out

    for _ in range(traffic["warmup_steps"]):
        step()
    if cuda:
        torch.cuda.synchronize()

    cost = {"off": [], "on": []}
    window = spans.SpanRecord(step_ms=[], window_steps=0, level_launches=0, eligible_levels=0)
    counters = Counter()
    for r in range(args.blocks):
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            if mode == "on":
                profiling.enable_tracing()
            ms = block(step, args.block_seconds)
            if mode == "on":
                profiling.disable_tracing()
                drained = profiling.drain()
                window.spans += drained["spans"]
                counters.update(drained["counters"])
            cost[mode].append(ms)
    window.counters = dict(counters)

    reads = {"off": 0, "on": 0}
    identical = True
    for _ in range(traffic["host_read_steps"]):
        saved, k = session._state, counter[0]
        out = {}
        for mode in ("off", "on"):
            session._state, counter[0] = saved, k
            if mode == "on":
                profiling.enable_tracing()
            if cuda:
                reads[mode] += trace.count_host_reads(lambda: out.__setitem__(mode, step()))
            else:
                out[mode] = step()
            profiling.disable_tracing()
        profiling.drain()
        identical &= bool(np.array_equal(out["off"], out["on"]))

    profiling.enable_tracing()
    device, launch, steps_us, ranges = profile_with_launches(step, traffic["profile_steps"], cuda)
    profiling.disable_tracing()
    drained = profiling.drain()
    profiled = spans.SpanRecord(step_ms=[], window_steps=0, level_launches=0, eligible_levels=0,
                                profiled_steps=len(steps_us), steps=steps_us,
                                window_us=steps_us[-1][1] - steps_us[0][0], device=device,
                                spans=drained["spans"], counters=drained["counters"],
                                launch_us=launch)
    pyramid = spans.launched_in_us(profiled, spans.PYRAMID)
    in_ranges = sum(1 for t in launch if t is not None
                    and any(a <= t <= b for a, b in ranges.get(spans.PYRAMID, [])))
    in_spans = sum(1 for t in launch if t is not None
                   and any(a <= t <= b for a, b in spans.intervals_us(profiled, spans.PYRAMID)))

    med = {m: statistics.median([x for b in cost[m] for x in b]) for m in cost}
    readings = {name: getattr(spans, name)(window) for name in READERS}
    readings["pyramid_ms"] = None if pyramid is None else pyramid / 1e3 / len(steps_us)
    line = {
        "workload": args.workload, "seed": args.seed, "card": card, "streams": streams,
        "readings": readings,
        "window_steps": sum(1 for s in window.spans
                            if s["name"] == spans.STEP_ROOT and s["parent"] is None),
        "counters": window.counters,
        "host": host_breakdown(window),
        "cost": {"step_ms_p50_off": med["off"], "step_ms_p50_on": med["on"],
                 "on_over_off_pct": 100.0 * (med["on"] / med["off"] - 1.0),
                 "block_p50_ms": {m: [statistics.median(b) for b in cost[m]] for m in cost},
                 "block_fps": {m: [streams * len(b) / (sum(b) / 1e3) for b in cost[m]]
                               for m in cost}},
        "host_reads": {m: reads[m] / traffic["host_read_steps"] for m in reads} if cuda else None,
        "identical": identical,
        "launches_matched": sum(t is not None for t in launch), "device_ops": len(device),
        "pyramid_launches": {"in_program_spans": in_spans, "in_profiler_ranges": in_ranges},
        "clock": clock_check(drained["spans"], ranges),
        "profiled_counters": drained["counters"],
    }
    rows = spans.idle_by_span(profiled)
    if rows is not None:
        print(spans.idle_table(rows), file=sys.stderr)
        line["idle_by_span"] = [[label, ms, pct] for label, ms, pct in rows[:16]]
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
