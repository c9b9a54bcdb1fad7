"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The cell is looked up in ``BENCHMARK.json``; its files are found by name
(``harness/cell.py``).  With ``--trace 0`` the last line of standard
output carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics; either way ``correct`` says whether the poses, states
and pyramids of the timed path agree with the plain reference, and the
numbers compared close the line and standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "dense_visual_odometry_tpu")


def set_environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through a library."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, outcome, trace_on: bool, correct: bool, checks: dict, device: dict) -> dict:
    from portbench.harness import trace

    metrics = {}
    for spec in cell.metric_specs(trace_on):
        if trace_on:
            value = cell.reader(spec["name"])(outcome.record)
        else:
            value = outcome.metrics.get(spec["name"])
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if trace_on:
        rec = outcome.record
        line["device"] = dict(device, busy_s=trace.busy_us(rec) / 1e6, window_s=rec.window_us / 1e6)
        line["breakdown"] = trace.breakdown(rec)
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    import torch

    from portbench.harness import check
    from portbench.harness.cell import load_cell
    from portbench.roofline import power_limit

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    print(f"card: {power_limit()}", flush=True)
    outcome = cell.entry().run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    correct, checks = check.verdict(outcome.numbers, cell.limits)
    print(f"numbers: {json.dumps(outcome.numbers)}", flush=True)
    line = result_line(cell, outcome, bool(args.trace), correct, checks, outcome.notes["device"])
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
