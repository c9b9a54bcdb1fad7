"""The JAX package and the port on ``chip_smoke.py``'s scene, on the CPU: the
tracking errors that ``chip_smoke.BOUNDS`` are set from.

    JAX_PLATFORMS=cpu python -m tests.jax_smoke_scene [--band N] [CONFIG ...]
    JAX_PLATFORMS=cpu python -m tests.jax_smoke_scene --cli
    JAX_PLATFORMS=cpu python -m tests.jax_smoke_scene --slam
    JAX_PLATFORMS=cpu python -m tests.jax_smoke_scene --mapping
    JAX_PLATFORMS=cpu python -m tests.jax_smoke_scene --sparse
    JAX_PLATFORMS=cpu python -m tests.jax_smoke_scene --train

CONFIG is ``tpu_fast`` (the default) or a name of ``chip_smoke.VARIANTS``
(``fast_prior``, ``fast_depth``, ...).  The scene is the smoke's own
(``chip_smoke.make_sequence``: 640x480, 16 frames, exact truth); ``--band
N`` zeroes the depth within N pixels of the image border in every frame,
as ``test_torch_track.py`` does, so that no template pixel projects onto
the bounds test's edge.  For each configuration, one JSON line with both
packages' errors against the truth, in the smoke's terms, and how far
their transforms part:

- ``cross_pairs``: the smoke's two cross-check pairs (0, 1) and (7, 8) as
  one batch;
- ``all_pairs``: the 15 consecutive pairs as one batch (the smoke's B=64
  batch cycles the same 15, and the hard-motion trigger is batch-global,
  so each pair takes the same branches);
- ``session``: a 16-frame ``OdometrySession`` (drift: the largest
  translation error against the truth relative to the first frame).

The motion prior's batched pairs are anchored as the smoke anchors them
(``chip_smoke.previous_motions``).  With the depth term, the line also
holds the depth residuals at the true motion of the 15 pairs at level 0
(``depth_at_truth``).  About 10 minutes a configuration and 5 GB; the
Pallas kernels run in interpret mode, as the JAX package's own CPU tests
run them.

``--slam``: the smoke's SLAM phase (6) on the CPU instead
(``chip_smoke.SLAM_BOUNDS`` and ``SLAM_CLI_BOUNDS`` are set from it): a
``SlamSession`` of each package under ``configs/tpu_slam.json`` and
``chip_smoke.SLAM_POLICY``, direct and two-step, over the 16 frames, one
JSON line a mode with the keyframes, loop closures and the largest
errors of the front-end poses and of ``optimized_trajectory``; then both
packages' ``apps.benchmark -m slam`` (plain, ``--slam-two-step``,
``--dense-refine``) on the CLI directory, one line a run with ATE and RPE.
The JAX package's Pallas kernels run in interpret mode at 640x480: about
an hour and 6 GB.

``--mapping``: the smoke's mapping phase (7) on the CPU instead
(``chip_smoke.MAPPING_BOUNDS`` are set from it): the JAX package's
``apps.reconstruct`` on the CLI directory for each of
``chip_smoke.MAPPING_RUNS`` under ``configs/tpu_fast.json``, one JSON line a
run with the ATE of its poses and the median |z - true depth| of its mesh's
vertices in frame 0 (``chip_smoke.mapping_errors``).  The poses are the ones
its ``_track_poses`` returns to its ``main``, read by wrapping that function
for the run.  The Pallas kernels run in interpret mode at 640x480: about 5
minutes.

``--sparse``: the smoke's sparse phase (8) on the CPU instead
(``chip_smoke.SPARSE_CLI_BOUNDS`` are set from it): both packages'
``apps.benchmark -m sparse`` on the CLI directory with each of
``chip_smoke.SPARSE_MATCHERS``, one JSON line a matcher with both
summaries' ATE and RPE (the packages draw RANSAC's samples from different
random streams, so their trajectories part by more than rounding).  About
5 minutes, most of it the learned matcher's attention at 640x480.

``--train``: the smoke's training run (phase 9) on the CPU instead
(``chip_smoke.TRAIN_BOUNDS`` are set from it): both packages'
``apps.train_matcher`` at their default widths and schedule on the
bundled-format directory ``chip_smoke.bundled_dataset`` writes (10 frames
at 640x480), one JSON line a package with its summary (the packages draw
their initial weights from different random streams).  About 15 minutes.

``--cli``: the smoke's CLI phase on the CPU instead (``chip_smoke.CLI_BOUNDS``
are set from it): the directory ``chip_smoke.cli_dataset`` writes, tracked by
both packages' ``apps.benchmark.run`` with the platform cpu under each of
``chip_smoke.CLI_CONFIGS``; one JSON line a configuration with both
summaries' ATE and RPE and how far the trajectories part.
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as cs
from dense_visual_odometry_torch.models.session import OdometrySession as TSession
from dense_visual_odometry_torch.parallel import batched_track_pair
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.config import RobustDVOConfig as JConfig
from dense_visual_odometry_tpu.models import robust as jrobust
from dense_visual_odometry_tpu.models.session import OdometrySession as JSession
from dense_visual_odometry_tpu.ops.residuals import depth_residuals

CROSS_PAIRS = [(0, 1), (7, 8)]
PAIRS = [(i, i + 1) for i in range(cs.N_FRAMES - 1)]


def jax_config(name: str) -> JConfig:
    base, overrides = cs.VARIANTS.get(name, (name, {}))
    data = json.loads((cs.CONFIGS / f"{base}.json").read_text())
    return JConfig.from_dict({**data, **overrides})


def errors(est: np.ndarray, gt: np.ndarray) -> dict:
    terr, rerr = cs.pose_errors(est, gt)
    return {"translation_err_mm": (terr * 1e3).tolist(),
            "translation_err_mm_median": float(np.median(terr) * 1e3),
            "translation_err_mm_max": float(np.max(terr) * 1e3),
            "rotation_err_deg_max": float(np.degrees(np.max(rerr)))}


def compare(est_j: np.ndarray, est_t: np.ndarray, gt: np.ndarray) -> dict:
    gap = np.abs(est_j - est_t).reshape(est_j.shape[0], -1).max(axis=1)
    return {"jax": errors(est_j, gt), "port": errors(est_t, gt),
            "max_abs_transform_diff": gap.tolist()}


def batched(scene, name, pairs) -> dict:
    """Both packages on ``pairs`` as one batch."""
    poses, k_np = scene["poses"], scene["k"]
    prev, curr, last = cs.batch_inputs(scene["port_frames"], poses, pairs, "cpu",
                                       name in cs.PRIOR_CONFIGS)

    def jstack(idx):
        return jax.tree.map(lambda *x: jnp.stack(x), *[scene["jax_frames"][i] for i in idx])

    out_j = jrobust.make_tracker(jax_config(name))(
        jstack([i for i, _ in pairs]), jstack([j for _, j in pairs]), jnp.asarray(k_np),
        last_transform=None if last is None else jnp.asarray(last.numpy()))
    out_t = batched_track_pair(prev, curr, torch.as_tensor(k_np), cs.config(name),
                               last_transform=last)
    gt = np.stack([cs.gt_transform(poses, i, j) for i, j in pairs])
    return compare(np.asarray(out_j.transform), out_t.transform.numpy(), gt)


def sessions(scene, name) -> dict:
    grays, depths, poses = scene["grays"], scene["depths"], scene["poses"]
    js = JSession(JCamera.create(scene["k"], 1.0), jax_config(name))
    ts = TSession(cs.CameraModel.create(scene["k"], 1.0), cs.config(name), device="cpu")
    est_j = np.stack([np.asarray(js.step(g, d).matrix) for g, d in zip(grays, depths)])
    est_t = np.stack([ts.step(g, d).matrix.numpy() for g, d in zip(grays, depths)])
    gt = np.einsum("ij,njk->nik", np.linalg.inv(poses[0]), poses)
    row = compare(est_j, est_t, gt)
    for side in ("jax", "port"):
        e = row[side]
        row[side] = {"translation_err_mm_max": e["translation_err_mm_max"],
                     "translation_err_mm_final": e["translation_err_mm"][-1],
                     "rotation_err_deg_max": e["rotation_err_deg_max"]}
    row["max_abs_transform_diff"] = max(row["max_abs_transform_diff"])
    return row


def depth_at_truth(scene, cfg: JConfig) -> dict:
    """The depth residuals at the true motion of the 15 pairs, level 0 (the
    gradients play no part in the residual), in mm."""
    s = cfg.stride_for_level(0)
    frames, r_all = scene["jax_frames"], []
    for i, j in PAIRS:
        zp = frames[i].depth_m[0][::s, ::s]
        zero = jnp.zeros_like(zp)
        gt = jnp.asarray(cs.gt_transform(scene["poses"], i, j), jnp.float32)
        r, _, valid = depth_residuals(zp, frames[j].depth_m[0], jnp.asarray(scene["k"]), gt,
                                      zero, zero, s)
        r_all.append(np.asarray(r, np.float64)[np.asarray(valid)])
    r = np.concatenate(r_all) * 1e3
    return {"pixels": int(r.size), "mean_mm": float(r.mean()),
            "median_abs_mm": float(np.median(np.abs(r))),
            "p99_abs_mm": float(np.percentile(np.abs(r), 99)),
            "rms_mm": float(np.sqrt(np.mean(r * r))),
            "share_above_huber": float(np.mean(np.abs(r) > cfg.depth_huber_delta * 1e3))}


def cli_runs() -> int:
    """Both packages' benchmark CLI on the smoke's CLI directory."""
    import tempfile
    from pathlib import Path
    from types import SimpleNamespace

    from dense_visual_odometry_torch.apps import benchmark as tbench
    from dense_visual_odometry_tpu.apps import benchmark as jbench

    keys = ("ate_rmse_m", "rpe_trans_rmse_m", "rpe_rot_rmse_rad", "frames")
    with tempfile.TemporaryDirectory(prefix="dvo_cli_") as tmp:
        root = Path(tmp)
        seq_dir, cam = cs.cli_dataset(root)
        for name in cs.CLI_CONFIGS:
            row = {"config": name}
            for side, bench in (("jax", jbench), ("port", tbench)):
                args = SimpleNamespace(
                    benchmark="tum", data_dir=str(seq_dir), camera=str(cam),
                    config=str(cs.config_file(name, root)), size=None, method="robust-dvo",
                    platform="cpu", output_dir=str(root / f"{side}_{name}"), profile_dir=None,
                    pipeline=False, host_gray=False, pyr_down=False, verbose=False)
                summary = bench.run(args)
                row[side] = {k: summary[k] for k in keys}
            est = [np.loadtxt(root / f"{side}_{name}" / "trajectory.txt")[:, 1:4]
                   for side in ("jax", "port")]
            row["max_abs_translation_diff_m"] = float(np.abs(est[0] - est[1]).max())
            print(json.dumps(row), flush=True)
    return 0


def slam_runs() -> int:
    """Both packages' SLAM on the smoke's scene and through the CLI."""
    import tempfile
    from pathlib import Path
    from types import SimpleNamespace

    from dense_visual_odometry_torch.apps import benchmark as tbench
    from dense_visual_odometry_torch.models.slam import SlamSession as TSlam
    from dense_visual_odometry_tpu.apps import benchmark as jbench
    from dense_visual_odometry_tpu.models.slam import KeyframePolicy as JPolicy
    from dense_visual_odometry_tpu.models.slam import SlamSession as JSlam

    grays, depths, k_np, poses = cs.make_sequence()
    truths = list(poses)
    for mode, extra in cs.SLAM_MODES.items():
        kw = {**cs.SLAM_POLICY, **extra}
        row = {"mode": mode, "policy": kw}
        for side in ("jax", "port"):
            if side == "jax":
                sess = JSlam(JCamera.create(k_np, 1.0), jax_config(cs.SLAM_CONFIG), JPolicy(**kw))
            else:
                sess = TSlam(cs.CameraModel.create(k_np, 1.0), cs.config(cs.SLAM_CONFIG),
                             cs.slam_policy(**kw), device="cpu")
            for g, d in zip(grays, depths):
                sess.step(g, d)
            front = np.stack([np.asarray(p, np.float64) for p in sess.frame_poses])
            row[side] = {"keyframe_indices": list(sess.keyframe_indices),
                         "loop_closures": [[a, b] for a, b, _ in sess.loop_closures],
                         "front": cs.slam_errors(front, truths),
                         "optimized": cs.slam_errors(sess.optimized_trajectory(), truths)}
            row[f"{side}_poses"] = front
        row["max_abs_pose_diff"] = float(np.abs(row.pop("jax_poses") - row.pop("port_poses")).max())
        print(json.dumps(row), flush=True)

    keys = ("ate_rmse_m", "rpe_trans_rmse_m", "rpe_rot_rmse_rad", "frames", "keyframes")
    with tempfile.TemporaryDirectory(prefix="dvo_cli_") as tmp:
        root = Path(tmp)
        seq_dir, cam = cs.cli_dataset(root)
        for name, flags in cs.SLAM_CLI_RUNS.items():
            row = {"run": name}
            for side, bench in (("jax", jbench), ("port", tbench)):
                args = SimpleNamespace(
                    benchmark="tum", data_dir=str(seq_dir), camera=str(cam),
                    config=str(cs.CONFIGS / f"{cs.SLAM_CONFIG}.json"), size=None,
                    method="slam", platform="cpu", output_dir=str(root / f"{side}_{name}"),
                    profile_dir=None, pipeline=False, host_gray=False, pyr_down=False,
                    verbose=False, slam_two_step="--slam-two-step" in flags,
                    slam_refine_caps=None, dense_refine="--dense-refine" in flags)
                summary = bench.run(args)
                row[side] = {k: summary[k] for k in keys}
            print(json.dumps(row), flush=True)
    return 0


def mapping_runs() -> int:
    """The JAX package's reconstruct CLI on the smoke's CLI directory."""
    import tempfile
    from pathlib import Path

    from dense_visual_odometry_torch.io.datasets import load_tum_sequence
    from dense_visual_odometry_tpu.apps import reconstruct as jrec

    with tempfile.TemporaryDirectory(prefix="dvo_map_") as tmp:
        root = Path(tmp)
        seq_dir, cam = cs.cli_dataset(root)
        gt = load_tum_sequence(seq_dir, camera_yaml=cam).gt_poses
        k = np.asarray(cs.synthetic.TUM_FR1_INTRINSICS, np.float64)
        depth0 = cs.true_depth0()
        for name in cs.MAPPING_RUNS:
            argv = cs.reconstruct_argv(seq_dir, cam, root / "jax", name)
            argv[0] = "tum-fr1"  # the JAX CLI's name for a TUM directory
            track, poses = jrec._track_poses, []

            def kept(*args, **kw):
                poses.append(track(*args, **kw))  # noqa: B023
                return poses[-1]  # noqa: B023

            jrec._track_poses = kept
            try:
                jrec.main([*argv, "--platform", "cpu"])
            finally:
                jrec._track_poses = track
            mesh = Path(argv[argv.index("-o") + 1])
            print(json.dumps({"run": name, **cs.mapping_errors(poses[0], gt, mesh, k, depth0)}),
                  flush=True)
    return 0


def sparse_runs() -> int:
    """Both packages' ``-m sparse`` CLI on the smoke's CLI directory."""
    import tempfile
    from pathlib import Path
    from types import SimpleNamespace

    from dense_visual_odometry_torch.apps import benchmark as tbench
    from dense_visual_odometry_tpu.apps import benchmark as jbench

    keys = ("ate_rmse_m", "rpe_trans_rmse_m", "rpe_rot_rmse_rad", "frames", "median_frame_ms")
    with tempfile.TemporaryDirectory(prefix="dvo_sparse_") as tmp:
        root = Path(tmp)
        seq_dir, cam = cs.cli_dataset(root)
        for matcher in cs.SPARSE_MATCHERS:
            row = {"matcher": matcher}
            for side, bench in (("jax", jbench), ("port", tbench)):
                args = SimpleNamespace(
                    benchmark="tum", data_dir=str(seq_dir), camera=str(cam), config=None,
                    size=None, method="sparse", sparse_matcher=matcher, platform="cpu",
                    output_dir=str(root / f"{side}_{matcher}"), profile_dir=None,
                    pipeline=False, host_gray=False, pyr_down=False, verbose=False)
                summary = bench.run(args)
                row[side] = {k: summary[k] for k in keys}
            print(json.dumps(row), flush=True)
    return 0


def train_runs() -> int:
    """Both packages' ``apps.train_matcher`` on the smoke's training data."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from dense_visual_odometry_torch.apps import train_matcher as ttrain
    from dense_visual_odometry_tpu.apps import train_matcher as jtrain

    with tempfile.TemporaryDirectory(prefix="dvo_train_") as tmp:
        root = Path(tmp)
        data = cs.bundled_dataset(root / "bundled")
        for side, tool in (("jax", jtrain), ("port", ttrain)):
            argv = ["--data-dir", str(data), "-o", str(root / f"{side}.npz"),
                    "--platform", "cpu"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                tool.main(argv)
            lines = buf.getvalue().strip().splitlines()
            losses = [ln for ln in lines if ln.startswith("step ")]
            print(json.dumps({"package": side, "progress": losses,
                              **json.loads(lines[-1])}), flush=True)
    return 0


def main(argv) -> int:
    jax.config.update("jax_platforms", "cpu")
    if argv[:1] == ["--train"]:
        return train_runs()
    if argv[:1] == ["--sparse"]:
        return sparse_runs()
    if argv[:1] == ["--mapping"]:
        return mapping_runs()
    if argv[:1] == ["--cli"]:
        return cli_runs()
    if argv[:1] == ["--slam"]:
        return slam_runs()
    band = 0
    if argv[:1] == ["--band"]:
        band, argv = int(argv[1]), argv[2:]
    grays, depths, k_np, poses = cs.make_sequence()
    for d in depths:
        if band:
            d[:band], d[-band:], d[:, :band], d[:, -band:] = 0, 0, 0, 0
    jcam = JCamera.create(k_np, 1.0)  # rendered depth is already metric
    tcam = cs.CameraModel.create(k_np, 1.0)
    for name in argv or ["tpu_fast"]:
        cfg = jax_config(name)
        prep = jax.jit(lambda g, d: jrobust.preprocess_frame(  # noqa: B023
            g, d, jcam, levels=cs.LEVELS, max_distance=cfg.max_distance))
        scene = {
            "grays": grays, "depths": depths, "k": k_np, "poses": poses,
            "jax_frames": [jax.tree.map(np.asarray, prep(g, d)) for g, d in zip(grays, depths)],
            "port_frames": [cs.robust.preprocess_frame(g, d, tcam, levels=cs.LEVELS,
                                                       max_distance=cfg.max_distance,
                                                       device="cpu")
                            for g, d in zip(grays, depths)],
        }
        row = {"config": name, "band": band,
               "cross_pairs": batched(scene, name, CROSS_PAIRS),
               "all_pairs": batched(scene, name, PAIRS),
               "session": sessions(scene, name)}
        if cfg.use_depth_residuals:
            row["depth_at_truth"] = depth_at_truth(scene, cfg)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
