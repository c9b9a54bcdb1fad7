"""Readings of the comparison that decides ``correct``: the program's and
its control's, on the chip at a cell's own size.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] \
        [--controls <n> ...]

Each seed, in one process, is one run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds``, the judgement), whose numbers are the
program's readings.  For the seeds in ``--controls`` the line also holds:

- ``tf32_program``: the same run with the program's TF32 switched on (the
  port switches it off for matrix products and convolutions at import);
- ``tf32_reference``, the control: the reference put in the program's
  place, computed in TF32 (``reference.dvo.tf32``): the sampled frames'
  motions solved from the true motion, each pose composed from the
  program's previous pose, the sampled streams' pyramids.

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

from portbench.run import set_environment  # noqa: E402


def tf32_reference(evidence, seed: int, n_pairs: int, state_streams: int) -> dict:
    """The control's numbers: the reference in the program's place, in TF32."""
    import numpy as np
    import torch

    from portbench.harness import check
    from portbench.harness.drive import POSE
    from portbench.reference import dvo

    frames, tier, schedule, outputs, first = evidence
    pairs = check.sample_pairs(outputs, schedule, first, n_pairs, seed + 1)
    prev_idx, curr_idx = check.pair_frames(outputs, schedule, pairs)
    ref = check.reference_motions(frames, tier, prev_idx, curr_idx)
    motion = check.reference_motions(frames, tier, prev_idx, curr_idx, rnd=dvo.tf32)
    prev_pose = torch.as_tensor(np.stack([outputs[i - 1][s, POSE].reshape(4, 4) for i, s in pairs]),
                                device=motion.device)
    pose = dvo.compose(prev_pose, motion, dvo.tf32).double()
    implied = torch.linalg.inv(pose) @ prev_pose.double()
    out = check.motion_gaps(implied.cpu().numpy(), ref)
    tr, rot = dvo.motion_gap(dvo.compose(prev_pose, motion), pose)
    out.update(compose_gap_mm=float(tr.max()), compose_gap_deg=float(rot.max()))
    idx = torch.as_tensor(curr_idx[:state_streams], device=frames.rgb.device)
    g = dvo.pyramid(dvo.luma(frames.rgb[idx], dvo.tf32), tier.levels)
    z = dvo.pyramid(dvo.metres(frames.depth[idx], frames.depth_factor, tier.max_distance,
                               dvo.tf32), tier.levels)
    out["gray_gap"], out["depth_gap"] = check.pyramid_gaps(
        frames, tier, curr_idx[:state_streams], g, z)
    out["lost_pct"] = 0.0  # the reference refuses no frame
    return out


def set_tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


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
        outcome = cell.entry().run(cell, seed, args.seconds, False, t0)
        return cell, outcome

    for i, seed in enumerate(args.seeds):
        cell, outcome = run(seed, T_START if i == 0 else time.perf_counter())
        correct, _ = check.verdict(outcome.numbers, cell.limits)
        line = {"workload": args.workload, "seed": seed, "correct": correct,
                "program": outcome.numbers, "metrics": outcome.metrics}
        if seed in args.controls:
            evidence = outcome.notes["evidence"]
            n_pairs, streams = cell.traffic["check_pairs"], cell.traffic["state_streams"]
            line["tf32_reference"] = tf32_reference(evidence, seed, n_pairs, streams)
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
