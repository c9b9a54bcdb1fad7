"""Trajectory evaluation CLI: ATE / RPE between two TUM trajectory files.

Counterpart of ``dense_visual_odometry_tpu/apps/evaluate.py``, printing the
same JSON:

    python -m dense_visual_odometry_torch.apps.evaluate est.txt gt.txt
    python -m dense_visual_odometry_torch.apps.evaluate est.txt gt.txt \
        --max-time-diff 0.02 --rpe-delta 1 -o metrics.json

Timestamps are associated nearest-neighbour within ``--max-time-diff``
(the TUM convention); unmatched poses are dropped and reported.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ATE/RPE between TUM trajectories")
    p.add_argument("estimated", type=str)
    p.add_argument("groundtruth", type=str)
    p.add_argument("--max-time-diff", type=float, default=0.02,
                   help="max timestamp difference for association (s)")
    p.add_argument("--rpe-delta", type=int, default=1, help="RPE frame gap")
    p.add_argument("--no-align", action="store_true",
                   help="skip Umeyama SE(3) alignment before ATE")
    p.add_argument("-o", "--output", type=str, default=None, help="JSON out")
    return p.parse_args(argv)


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_diff: float):
    """Greedy nearest-timestamp association -> (idx_a, idx_b) arrays."""
    if len(ts_a) == 0 or len(ts_b) == 0:
        return np.zeros(0, int), np.zeros(0, int)
    nearest = np.abs(ts_a[:, None] - ts_b[None, :]).argmin(axis=1)
    diffs = np.abs(ts_a - ts_b[nearest])
    keep = diffs <= max_diff
    # One-to-one: keep the best a for each matched b.
    idx_a, idx_b = [], []
    used_b = {}
    for a in np.nonzero(keep)[0]:
        b = nearest[a]
        if b not in used_b or diffs[a] < diffs[used_b[b]]:
            used_b[b] = a
    for b, a in sorted(used_b.items()):
        idx_a.append(a)
        idx_b.append(b)
    return np.asarray(idx_a, int), np.asarray(idx_b, int)


def main(argv=None):
    args = parse_args(argv)
    # Host-side file reading and numpy scoring: no device is touched.
    from dense_visual_odometry_torch import metrics
    from dense_visual_odometry_torch.io import trajectory

    ts_est, est = trajectory.load_tum_trajectory(args.estimated)
    ts_gt, gt = trajectory.load_tum_trajectory(args.groundtruth)
    ia, ib = associate(ts_est, ts_gt, args.max_time_diff)
    if len(ia) < 2:
        print(json.dumps({"error": "fewer than 2 associated poses"}))
        return 1
    est_m, gt_m = est[ia], gt[ib]

    ate, per_frame = metrics.ate_rmse(est_m, gt_m, align=not args.no_align)
    rpe_t, rpe_r = metrics.rpe(est_m, gt_m, delta=args.rpe_delta)
    out = {
        "pairs": int(len(ia)),
        "dropped_estimated": int(len(ts_est) - len(ia)),
        "dropped_groundtruth": int(len(ts_gt) - len(ia)),
        "ate_rmse_m": float(ate),
        "ate_mean_m": float(per_frame.mean()),
        "ate_median_m": float(np.median(per_frame)),
        "ate_max_m": float(per_frame.max()),
        "rpe_trans_rmse_m": rpe_t,
        "rpe_rot_rmse_rad": rpe_r,
        "aligned": not args.no_align,
    }
    print(json.dumps(out))
    if args.output:
        Path(args.output).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
