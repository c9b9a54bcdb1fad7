"""Benchmark CLI: track an RGB-D sequence, report timing and accuracy.

Counterpart of ``dense_visual_odometry_tpu/apps/benchmark.py`` (its
robust-dvo path): the bundled set (``test``) or a TUM RGB-D directory
(``tum`` / ``tum-fr1``), a JSON solver configuration, and a report JSON, a
TUM trajectory and ATE / RPE against the ground truth::

    python -m dense_visual_odometry_torch.apps.benchmark tum -d DIR \\
        --camera cam.yaml -c configs/tpu_fast.json -o out/
    python -m dense_visual_odometry_torch.apps.benchmark tum -d DIR \\
        --camera cam.yaml --platform cpu

It runs on the GPU; ``--platform cpu`` runs the kernels' plain versions on
the CPU, and without a GPU nothing else does.  The first frame's time
includes building the kernels where they are not built yet; the summary
keeps it apart from the steady state.  ``fps`` (the JAX package's
definition) times the tracking step alone, after the first frame;
``read_s`` is the part of ``total_time_s`` spent waiting for frames to be
read, and ``frames / total_time_s`` the rate a replay of the sequence
runs at.  ``-m slam`` runs keyframe SLAM (``models/slam.py``; with
``--slam-two-step`` and ``--slam-refine-caps`` the two-step front end, with
``--dense-refine`` a global pose graph and dense BA after the run) and
reports the BA-optimized trajectory and the keyframe count; ``-m sparse``
runs the sparse pipeline (``models/sparse.py``: Harris + ZNCC, or with
``--sparse-matcher learned`` the LoFTR-lite matcher of ``models/matcher.py``
with the weights committed in ``dense_visual_odometry_tpu/weights/``, read
by path) on the frames' gray, converted on the host as ``cv2.cvtColor``
does.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import Iterable, Iterator

logger = logging.getLogger("dvo.benchmark")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Dense visual odometry benchmark")
    parser.add_argument("benchmark", choices=["test", "tum-fr1", "tum"], help="dataset type")
    parser.add_argument("-d", "--data-dir", type=str, default=None, help="dataset directory")
    parser.add_argument("-c", "--config", type=str, default=None, help="JSON solver config")
    parser.add_argument("-o", "--output-dir", type=str, default=None, help="output directory")
    parser.add_argument("--camera", type=str, default=None, help="camera intrinsics YAML")
    parser.add_argument("-s", "--size", type=int, default=None, help="max frames")
    parser.add_argument("-m", "--method", type=str, default="robust-dvo",
                        choices=["robust-dvo", "slam", "sparse"],
                        help="tracking pipeline (robust-dvo, the frame-to-frame solver; "
                        "slam, keyframe SLAM; sparse, matched features and a rigid fit)")
    parser.add_argument("--platform", type=str, default=None, choices=["cuda", "cpu"],
                        help="device to run on (default: the GPU; cpu runs the kernels' "
                        "plain versions)")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace (trace.json) into this dir, "
                             "with the tracer on, so that it holds the program's spans "
                             "(session.step, track.level, sync.*, ...)")
    parser.add_argument("--pipeline", action="store_true",
                        help="depth-1 pipelined stepping: dispatch frame k+1 before "
                        "reading frame k's pose (poses lag by one frame during the run)")
    parser.add_argument("--slam-refine-caps", type=str, default=None,
                        help="two-step SLAM: per-level refinement caps, finest first, "
                        "e.g. 6,4,3,3")
    parser.add_argument("--slam-two-step", action="store_true",
                        help="SLAM: frame-to-frame solve, then a short frame-to-keyframe "
                        "refinement (KeyframePolicy.two_step_tracking)")
    parser.add_argument("--dense-refine", action="store_true",
                        help="SLAM only: after the run, a global pose graph and dense "
                        "photometric BA over the retained keyframes (joint pose + inverse "
                        "depth), the refined depths fed back into the keyframes")
    parser.add_argument("--sparse-matcher", type=str, default="zncc",
                        choices=["zncc", "learned"],
                        help="matcher for -m sparse: Harris corners + ZNCC, or the "
                        "LoFTR-lite learned coarse matcher (the committed weights)")
    parser.add_argument("--host-gray", action="store_true",
                        help="convert RGB to uint8 gray on the host before upload "
                        "(the reference's uint8-gray semantics; a smaller upload)")
    parser.add_argument("--pyr-down", action="store_true",
                        help="track at half resolution (median blur + decimation, "
                        "intrinsics rescaled)")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser.parse_args(argv)


def _make_stepper(method: str, seq, cfg, device, host_gray: bool = False,
                  dense_refine: bool = False, slam_two_step: bool = False,
                  slam_refine_caps=None, sparse_matcher: str = "zncc"):
    """-> (step(rgb, depth) -> (4, 4) pose tensor, finalize() -> dict of
    summary entries) of the method: an ``OdometrySession`` for robust-dvo
    (its pose stays on the device), a ``SlamSession`` for slam, a
    ``SparseVO`` for sparse."""
    from dense_visual_odometry_torch.io.datasets import host_gray_u8

    if method == "slam":
        from dense_visual_odometry_torch.models.slam import KeyframePolicy, SlamSession

        policy = None
        if slam_two_step:
            kw = {}
            if slam_refine_caps:
                kw["refine_max_iterations"] = tuple(
                    int(x) for x in str(slam_refine_caps).split(","))
            policy = KeyframePolicy(two_step_tracking=True, **kw)
        slam = SlamSession(seq.camera, cfg, policy=policy, device=device)

        def step(rgb, depth):
            return slam.step(rgb, depth).matrix

        def finalize():
            extra = {"keyframes": slam.num_keyframes}
            if dense_refine:
                # The pose graph first (loop closures), then the dense
                # photometric pass over the retained keyframes, its refined
                # depths fed back into their pyramids.
                slam.optimize_full()
                extra["dense_refined"] = slam.refine_dense(update_depths=True) is not None
            extra["optimized_poses"] = slam.optimized_trajectory()
            return extra

        return step, finalize

    if method == "sparse":
        from dense_visual_odometry_torch.models.sparse import SparseVO

        vo = SparseVO(seq.camera, matcher=sparse_matcher, device=device)

        def step(rgb, depth):
            return vo.step(host_gray_u8(rgb).astype("float32"), depth)

        return step, dict

    from dense_visual_odometry_torch.models.session import OdometrySession

    session = OdometrySession(seq.camera, cfg, device=device)

    def step(rgb, depth):
        # The pose stays on the device, so the caller may pipeline.
        return session.step(host_gray_u8(rgb) if host_gray else rgb, depth).matrix

    return step, dict


def backend_name(device) -> str:
    """The device the run used: ``cuda:<card name>`` or ``cpu``."""
    import torch

    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def _timed(frames: Iterable, spent: list) -> Iterator:
    """Yield from ``frames``, adding to ``spent[0]`` the seconds spent
    waiting for each item."""
    it = iter(frames)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            spent[0] += time.perf_counter() - t0
        yield item


def run(args) -> dict:
    import numpy as np

    from dense_visual_odometry_torch import metrics
    from dense_visual_odometry_torch.config import RobustDVOConfig
    from dense_visual_odometry_torch.io import (
        load_bundled_sequence,
        load_tum_sequence,
        trajectory,
    )
    from dense_visual_odometry_torch.io.datasets import frame_route
    from dense_visual_odometry_torch.models.robust import resolve_device
    from dense_visual_odometry_torch.utils import profiling

    device = resolve_device(args.platform)
    if args.benchmark == "test":
        seq = load_bundled_sequence(args.data_dir, size=args.size)
    else:
        seq = load_tum_sequence(args.data_dir, camera_yaml=args.camera, size=args.size)

    if args.pyr_down:
        from dense_visual_odometry_torch.io.datasets import pyr_down_sequence

        seq = pyr_down_sequence(seq)

    cfg = RobustDVOConfig.from_json(args.config) if args.config else RobustDVOConfig(
        levels=4, use_weighter=True
    )
    logger.info("sequence '%s': %d frames; config: %s", seq.name, len(seq), cfg)
    logger.info("device: %s; frames read by: %s", backend_name(device), frame_route())

    step, finalize = _make_stepper(
        args.method, seq, cfg, device, host_gray=args.host_gray,
        dense_refine=bool(getattr(args, "dense_refine", False)),
        slam_two_step=bool(getattr(args, "slam_two_step", False)),
        slam_refine_caps=getattr(args, "slam_refine_caps", None),
        sparse_matcher=getattr(args, "sparse_matcher", "zncc"),
    )
    if args.profile_dir:
        profiling.enable_tracing()
        profiling.start_trace(args.profile_dir)

    def host(pose) -> np.ndarray:
        return pose.detach().cpu().numpy().astype(np.float64)

    pipeline = args.pipeline and args.method == "robust-dvo"
    poses, frame_times = [], []
    pending = None
    read_time = [0.0]
    t_start = time.perf_counter()
    for i, (rgb, depth) in enumerate(_timed(seq.prefetched(), read_time)):
        t0 = time.perf_counter()
        out = step(rgb, depth)
        if pipeline:
            # Depth-1 pipeline: dispatch this frame, then read the
            # previous frame's pose.
            if pending is not None:
                poses.append(host(pending))
            pending = out
        else:
            poses.append(host(out))
        dt = time.perf_counter() - t0
        frame_times.append(dt)
        if poses and seq.gt_poses is not None:
            # Per-frame error against the ground truth relative to frame 0.
            j = len(poses) - 1
            gt_rel = np.linalg.inv(seq.gt_poses[0]) @ seq.gt_poses[j]
            terr = np.linalg.norm(poses[-1][:3, 3] - gt_rel[:3, 3])
            logger.info("frame %d: %.1f ms, trans err %.4f m", i, dt * 1e3, terr)
        else:
            logger.info("frame %d: %.1f ms", i, dt * 1e3)
    if pending is not None:
        poses.append(host(pending))
    total_time = time.perf_counter() - t_start
    transforms = [np.eye(4)]
    for j in range(1, len(poses)):
        transforms.append(np.linalg.inv(poses[j]) @ poses[j - 1])
    if args.profile_dir:
        logger.info("profiler trace -> %s", profiling.stop_trace())
        profiling.disable_tracing()
        profiling.drain()

    extra = finalize()
    poses = np.stack(poses)
    if "optimized_poses" in extra:
        # SLAM: report the BA-optimized trajectory.
        poses = np.asarray(extra.pop("optimized_poses"))
    steady = frame_times[1:] if len(frame_times) > 1 else frame_times
    summary = {
        "frames": len(seq),
        "method": args.method,
        "total_time_s": total_time,
        "first_frame_s": frame_times[0],
        "mean_frame_ms": float(np.mean(steady) * 1e3),
        "median_frame_ms": float(np.median(steady) * 1e3),
        "fps": float(1.0 / np.mean(steady)),
        "read_s": read_time[0],
        "backend": backend_name(device),
        **extra,
    }

    if seq.gt_poses is not None:
        gt_rel = np.einsum(
            "ij,njk->nik", np.linalg.inv(seq.gt_poses[0]), seq.gt_poses
        )
        ate, _ = metrics.ate_rmse(poses, gt_rel)
        rpe_t, rpe_r = metrics.rpe(poses, gt_rel)
        trans_err, rot_err = metrics.per_frame_errors(poses, gt_rel)
        summary.update(
            ate_rmse_m=ate,
            rpe_trans_rmse_m=rpe_t,
            rpe_rot_rmse_rad=rpe_r,
            mean_trans_err_m=float(trans_err.mean()),
            mean_rot_err_rad=float(rot_err.mean()),
        )

    if args.output_dir:
        out = Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        trajectory.save_tum_trajectory(out / "trajectory.txt", seq.timestamps, poses)
        trajectory.save_report(
            out / "report.json",
            sequence_info=seq.extra,
            timestamps=seq.timestamps,
            estimated_poses=poses,
            transforms=transforms,
            gt_poses=seq.gt_poses,
            per_frame=[{"time_s": t} for t in frame_times],
            summary=summary,
        )
        logger.info("report written to %s", out)

    print(json.dumps(summary))
    return summary


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s: %(message)s",
        stream=sys.stdout,
    )
    return run(args)


if __name__ == "__main__":
    main()
