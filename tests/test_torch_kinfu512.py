"""KinectFusion at KinFu's proportions on the port, against the plain
float64 reference ``tests/plain_kinfu.py``, on the CPU.

KinFu (the benchmark's ``fr1-kinfu512``) fuses into a 512^3 cube of 3 m
(5.86 mm voxels) with a truncation of 30 mm (5.1 voxels) and marches each
ray through the volume only, every 0.8 truncation.  Here the proportions
are kept at a small size: a 120x160 view of a textured, bumped wall
0.6-1.0 m away (the TUM fr1 camera scaled), a cube of 1 m in front of it at
32^3 (31 mm voxels), 64^3 or, for the loop, 128^3, the truncation 5 voxels,
the march step 0.8 of it.  The port runs the tracker's tier ``configs/tpu_parity.json``; the
reference imports nothing of it.

- one fusion: every voxel's tsdf, weight and gray against the reference's;
- the volume march against the reference's march of the same volume;
- the default march (96 fixed steps from ``min_depth``) still what it was:
  the tracker's render path calls it as before, and it agrees with the
  reference's march started at ``min_depth`` on that schedule;
- each step of a short KinectFusion loop: the render it tracked against,
  its motion (against ``reference/dvo.refine``'s optimum on that render,
  started from the true motion) and its fusion at the returned pose;
- the loop's spans and counters, and that the tracer changes no pose.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.models import frame_to_model as f2m
from dense_visual_odometry_torch.models import tsdf
from dense_visual_odometry_torch.utils import profiling
from portbench.reference import dvo
from portbench.scene import synthetic
from tests import plain_kinfu as plain

TIER = Path(__file__).resolve().parents[1] / "configs" / "tpu_parity.json"
H, W = 120, 160
K = synthetic.TUM_FR1_INTRINSICS * np.array([[W / 640], [H / 480], [1.0]], np.float32)
NEAR = 0.6  # the wall's nearest depth, m
EXTENT, CENTER = 1.0, (0.0, 0.0, NEAR + 0.15)
# A float32 update parts from float64 by ~1e-6 of a truncation and ~3e-5 of
# a gray level; a voxel whose projection falls on a pixel's edge takes
# another pixel in one of them (a tie): at most this share of the voxels.
TSDF_GAP, GRAY_GAP, TIE_SHARE = 1e-4, 1e-3, 1e-3
# The march: float32 sample positions part from float64 by ~1e-7 m; a ray
# whose sample lies on a voxel's edge takes the neighbour in one of them.
DEPTH_ATOL_M, MARCH_EQUAL_SHARE, ONLY_ONE_SHARE = 1e-5, 0.99, 0.01
# The loop's motions (3 frames, 128^3), each against the reference's
# optimum on the port's render from the true motion, measured: 0.028 and
# 0.047 mm, 0.0022 and 0.0037 deg on this trajectory; the limits are ten
# times that.  (Seven other trajectories read up to 1.33 mm and 0.098 deg:
# the tier's levels stop on a relative step, and a template rendered from
# one or two frames is coarse.)  The frames move 0.9 and 1.9 mm and 0.385
# deg apart, so a rotation off by a tenth of that fails.
MOTION_ATOL_MM, MOTION_ATOL_DEG = 0.5, 0.04
N_LOOP = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: small CPU ops, which the suite's parallel
    workers would otherwise thrash over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """(poses camera-to-world, [(gray, depth_m)]) along a slow hand-held
    path in front of the wall."""
    rng = np.random.default_rng(0)
    gray = np.clip(128.0 + sum(a * synthetic._smooth_noise(rng, H, W, c)
                               for c, a in ((6, 35.0), (14, 30.0))), 0, 255).astype(np.float32)
    depth = (NEAR + np.linspace(0.0, 0.3, W)[None, :]
             + 0.1 * synthetic._smooth_noise(rng, H, W, 20)).astype(np.float32)
    poses = synthetic.handheld_trajectory(N_LOOP, seed=2, t_step=0.006, r_step=0.004,
                                          rpy_span=None, fast_span=None)
    return poses, [synthetic.render_view(gray, depth, K, np.linalg.inv(p)) for p in poses]


def volume_config(res: int) -> tsdf.TSDFConfig:
    return tsdf.TSDFConfig.around(CENTER, EXTENT, resolution=res,
                                  truncation=5.0 * EXTENT / res, max_weight=128.0)


def geometry(cfg: tsdf.TSDFConfig) -> plain.Geometry:
    return plain.Geometry(dims=cfg.dims, voxel=cfg.voxel_size, origin=cfg.origin,
                          truncation=cfg.truncation, max_weight=cfg.max_weight,
                          min_depth=cfg.min_depth)


def fused_volume(scene, cfg, frames=(0, 1)):
    """The port's volume after fusing ``frames`` at their true poses."""
    poses, views = scene
    vol = tsdf.make_volume(cfg, "cpu")
    for f in frames:
        tsdf.integrate(vol, views[f][1], views[f][0], K, np.linalg.inv(poses[0]) @ poses[f], cfg)
    return vol


def test_one_fusion_matches_plain(scene):
    poses, views = scene
    cfg = volume_config(32)
    before = fused_volume(scene, cfg, frames=(0,))
    fields = tuple(f.clone() for f in before)
    pose = np.linalg.inv(poses[0]) @ poses[1]
    after = tsdf.integrate(before, views[1][1], views[1][0], K, pose, cfg)
    ref = plain.fuse(fields, torch.tensor(views[1][1]), torch.tensor(views[1][0]), K, pose,
                     geometry(cfg), 0, cfg.dims[0])
    check_fusion(after, fields, ref)


def check_fusion(after, before, ref):
    changed = (ref[1] != before[1].double()).sum()
    assert changed > 0.1 * ref[1].numel()  # the frame reached a tenth of the volume
    off = (((after[0].double() - ref[0]).abs() > TSDF_GAP)
           | (after[1].double() != ref[1])
           | ((after[2].double() - ref[2]).abs() > GRAY_GAP))
    assert float(off.double().mean()) <= TIE_SHARE, int(off.sum())


@pytest.mark.parametrize("res", [32, 64])
def test_volume_march_matches_plain(scene, res):
    poses, _ = scene
    cfg = volume_config(res)
    vol = fused_volume(scene, cfg)
    pose = np.linalg.inv(poses[0]) @ poses[2]
    step = tsdf.VOLUME_MARCH_STEP * cfg.truncation
    n = tsdf.volume_march_steps(cfg, pose, step)
    assert n == plain.march_steps(geometry(cfg), pose, step)
    # From 0.3 m to 1.3 m or so: the cube's depth span over the step.
    assert EXTENT / step <= n <= np.sqrt(3) * EXTENT / step + 1
    depth, gray = tsdf.raycast_view_march_volume(vol, K, pose, cfg, (H, W), n, step)
    ref_d, ref_g = plain.march(vol, K, pose, geometry(cfg), (H, W), step, n)
    check_render(depth, gray, ref_d, ref_g)


def check_render(depth, gray, ref_d, ref_g):
    both = (depth > 0) & (ref_d > 0)
    assert float(both.double().mean()) > 0.5  # the wall fills most of the view
    only = float(((depth > 0) ^ (ref_d > 0)).double().mean())
    assert only <= ONLY_ONE_SHARE
    close = (depth.double() - ref_d).abs()[both] <= DEPTH_ATOL_M
    assert float(close.double().mean()) >= MARCH_EQUAL_SHARE
    gray_close = (gray.double() - ref_g).abs()[both] <= 1e-2
    assert float(gray_close.double().mean()) >= MARCH_EQUAL_SHARE


def test_default_march_is_unchanged(scene):
    """The tracker's render path with ``raycast="march"`` calls the default
    march as it did (bit for bit), and that march is still 96 fixed steps
    from ``min_depth`` to ``max_render_depth``."""
    poses, _ = scene
    cfg = volume_config(32)
    vol = fused_volume(scene, cfg)
    pose = np.linalg.inv(poses[0]) @ poses[2]
    via_tracker = f2m._vol_render(vol, torch.tensor(K), torch.tensor(pose, dtype=torch.float32),
                                  cfg, (H, W), 1.0, 10.0, "march")
    direct = tsdf.raycast_view_march(vol, K, pose, cfg, (H, W))
    for a, b in zip(via_tracker, direct):
        assert torch.equal(a, b)
    step = (10.0 - cfg.min_depth) / 96
    ref_d, ref_g = plain.march(vol, K, pose, geometry(cfg), (H, W), step, 96,
                               start=cfg.min_depth)
    check_render(*direct, ref_d, ref_g)


def kinfu_tracker(res: int) -> f2m.FrameToModelTracker:
    policy = f2m.ModelTrackerPolicy(render_every_frame=True, raycast="volume")
    return f2m.FrameToModelTracker(CameraModel.create(K, 1.0), RobustDVOConfig.from_json(TIER),
                                   volume_config(res), policy, device="cpu")


def test_kinfu_loop_matches_plain(scene):
    """Each step after the first against the reference: the render it
    tracked against (the reference's march of the volume the step started
    from, at the previous pose), its fusion (the reference's fusion of the
    frame into that volume at the returned pose) and its motion (the
    reference's optimum of the finest level on the port's render, started
    from the true motion)."""
    poses, views = scene
    tracker = kinfu_tracker(128)
    cfg = tracker.tsdf_config
    geo = geometry(cfg)
    step = tsdf.VOLUME_MARCH_STEP * cfg.truncation
    renders, motions, starts = [], [], []
    profiling.enable_tracing()
    try:
        for f, (gray, depth) in enumerate(views):
            before = tuple(x.clone() for x in tracker.volume)
            tracker.step(gray, depth)
            if f == 0:
                continue
            prev, world = tracker.frame_poses[-2], tracker.frame_poses[-1]
            ref_d, ref_g = plain.march(before, K, prev, geo, (H, W), step,
                                       plain.march_steps(geo, prev, step))
            check_render(*tracker.last_render, ref_d, ref_g)
            check_fusion(tracker.volume, before,
                         plain.fuse(before, torch.tensor(depth), torch.tensor(gray), K, world,
                                    geo, 0, cfg.dims[0]))
            renders.append(tracker.last_render)
            motions.append(tracker.last_transform)
            truth = np.linalg.inv(poses[0]) @ poses[f]
            starts.append(np.linalg.inv(truth) @ prev)
    finally:
        profiling.disable_tracing()
    drained = profiling.drain()
    assert tracker.failures == 0
    ref = dvo.refine(torch.stack([g for _, g in renders]).double(),
                     torch.stack([d for d, _ in renders]).double(),
                     torch.tensor(np.stack([g for g, _ in views[1:]])).double(),
                     torch.tensor(K, dtype=torch.float64), torch.tensor(np.stack(starts)),
                     RobustDVOConfig.from_json(TIER).grid_strides[0], True,
                     template_jacobian=True)
    tr, rot = dvo.motion_gap(ref, torch.tensor(np.stack(motions)))
    assert float(tr.max()) <= MOTION_ATOL_MM, tr
    assert float(rot.max()) <= MOTION_ATOL_DEG, rot

    # Spans: one step a frame; a render, a track, a read and a fusion each
    # after the first, which fuses only.
    names = [s["name"] for s in drained["spans"]]
    steps = [s for s in drained["spans"] if s["name"] == "session.step"]
    assert len(steps) == len(views) and all(s["streams"] == 1 for s in steps)
    for name, n in (("map.render", len(views) - 1), ("sync.map", len(views) - 1),
                    ("map.fuse", len(views))):
        assert names.count(name) == n, name
    assert "track.pair" in names and "frame.pyramid" in names
    c = drained["counters"]
    assert c["map.fused"] == len(views) and c.get("map.failed", 0) == 0
    assert c["map.voxels_fused"] == len(views) * 128 ** 3
    assert c["map.march_steps"] == sum(tsdf.volume_march_steps(cfg, p, step)
                                       for p in tracker.frame_poses[:-1])

    # The tracer on changes no pose, and the step's render is kept.
    quiet = kinfu_tracker(128)
    for gray, depth in views:
        quiet.step(gray, depth)
    assert np.array_equal(np.stack(quiet.frame_poses), np.stack(tracker.frame_poses))
    depth, gray = quiet.last_render
    assert depth.shape == (H, W) and float((depth > 0).double().mean()) > 0.5


def test_volume_march_needs_the_dense_volume():
    from dense_visual_odometry_torch.models.brick_tsdf import BrickTSDFConfig

    policy = f2m.ModelTrackerPolicy(render_every_frame=True, raycast="volume")
    with pytest.raises(ValueError):
        f2m.FrameToModelTracker(CameraModel.create(K, 1.0), RobustDVOConfig.from_json(TIER),
                                BrickTSDFConfig.around(CENTER, EXTENT, resolution=64,
                                                       pool_size=64, active_bricks=64),
                                policy, device="cpu")
    f2m.FrameToModelTracker(CameraModel.create(K, 1.0), RobustDVOConfig.from_json(TIER),
                            volume_config(32), policy, device="cpu")
