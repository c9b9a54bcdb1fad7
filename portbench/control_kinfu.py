"""Readings of the comparison that decides ``correct`` in a KinectFusion
cell (``kinfu512.b1.desk``): the program's and its control's, on the chip at
the cell's own size.

    python3 portbench/control_kinfu.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] \
        [--controls <n> ...]

Each seed, in one process, is one run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds``, the judgement of ``harness/map_check.py``),
whose numbers are the program's readings.  For the seeds in ``--controls``
the line also holds:

- ``tf32_program``: the same run with the program's TF32 switched on;
- ``tf32_reference``, the control: the reference put in the program's
  place and computed in TF32 (``reference.dvo.tf32``) for the run's sampled
  steps: each fusion of the copy at the returned pose, each render from the
  previous pose, each motion solved from the true motion with the program's
  render as the template, each pose composed from the program's previous
  pose; judged against float64 as the program is.

One JSON line per seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.control import set_tf32  # noqa: E402
from portbench.run import set_environment  # noqa: E402


def tf32_reference(ev) -> dict:
    """The control's numbers: the reference in the program's place, in TF32."""
    import numpy as np
    import torch

    from portbench.harness import check, map_check
    from portbench.harness.drive import SUCCESS
    from portbench.reference import dvo

    samples = [s for s in ev.samples if s.after is not None]
    out = {"pairs": float(len(samples))}
    out["fuse_diff_pct"] = max(map_check.fuse_diff_pct(ev, s, dvo.tf32) for s in samples)
    renders = [map_check.reference_render(ev, s, dvo.tf32) for s in samples]
    out.update(map_check.worst([map_check.render_numbers(r, map_check.reference_render(ev, s))
                                for r, s in zip(renders, samples)]))
    accepted = [s for s in samples if ev.outputs[s.step][0, SUCCESS] > 0.5]
    ref = map_check.reference_motions(ev, accepted)
    motion = map_check.reference_motions(ev, accepted, rnd=dvo.tf32)
    out.update(check.motion_gaps(motion.cpu().numpy(), ref))
    prev = torch.as_tensor(np.stack([map_check.pose_of(ev, s.step - 1) for s in accepted]),
                           device=motion.device)
    composed = dvo.compose(prev, motion, dvo.tf32).double()
    tr, rot = dvo.motion_gap(dvo.compose(prev, motion), composed)
    out.update(compose_gap_mm=float(tr.max()), compose_gap_deg=float(rot.max()))
    out["lost_pct"] = 0.0  # the reference refuses no frame
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, nargs="*", default=[],
                    help="seeds whose line also holds the controls' readings")
    args = ap.parse_args(argv)
    set_environment()
    import torch

    from portbench.harness import check
    from portbench.harness.cell import load_cell

    def run(seed, t0):
        cell = load_cell(args.workload, ROOT)
        return cell, cell.entry().run(cell, seed, args.seconds, False, t0)

    for i, seed in enumerate(args.seeds):
        cell, outcome = run(seed, T_START if i == 0 else time.perf_counter())
        correct, _ = check.verdict(outcome.numbers, cell.limits)
        line = {"workload": args.workload, "seed": seed, "correct": correct,
                "program": outcome.numbers, "metrics": outcome.metrics,
                "steps": outcome.notes["steps"], "device": outcome.notes["device"]}
        if seed in args.controls:
            line["tf32_reference"] = tf32_reference(outcome.notes["evidence"])
        del outcome
        torch.cuda.empty_cache()
        if seed in args.controls:
            set_tf32(True)
            try:
                _, tf32_run = run(seed, time.perf_counter())
            finally:
                set_tf32(False)
            line["tf32_program"] = tf32_run.numbers
            del tf32_run
            torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
