"""``FrameToModelTracker`` of the port against the JAX package's, on the CPU.

Both trackers run ``configs/tpu_fast.json`` (the JAX package's Pallas
kernels in interpret mode, the port's plain versions) over six 120x160
frames of the seeded synthetic scene (``synthetic.render_sequence`` along
``handheld_trajectory``; its depth, and the texture of the 60x80 scene
upsampled, cells of 4-20 pixels) with a 16-pixel band of invalid depth, as
``test_torch_track.py`` gives its frames (XLA:CPU fuses multiply-adds and
PyTorch does not; at the identity warp a border pixel's validity then turns
on the last bit).  The tracking volume is a 3.2 m cube of 128^3 voxels
(dense) or of (16, 16, 16) bricks of 8^3 (brick), centred in front of the
camera: 25 mm voxels, two pixels at the scene's depth.

The loop renders the map it fuses at the poses it tracks, so a difference
of a float32 ulp (XLA:CPU's fused multiply-adds) can grow: a tie voxel (one
whose projection lies at a half pixel) fused by one package and not the
other changes the next renders.  Measured, with the same scene at 64^3 and
the 120x160 texture (cells of 1.5-10 pixels, finer than the voxels): the
solves end at their iteration caps (residual scale ~24 against
``retrack_max_scale`` 10) and the trajectories part by 0.5-11 mm; at 128^3
with that texture the dense modes part by 4.8e-7 m and the brick mode by
3.7 mm after one tie voxel at frame 2; with the coarser texture here every
mode parts by at most 2e-6 m.

Three modes, one a file (this file keyframe renders with the splat
raycast, ``test_torch_frame_to_model_kinfu.py`` KinectFusion with the march,
``test_torch_frame_to_model_brick.py`` KinectFusion on the brick volume), so
that each file compiles one JAX tracker program.  They agree on the renders and
failed solves, and their trajectories within 1e-5 m and 1e-5 rad.  Then a
frame whose intensities are NaN (its depth intact, so that fusing it would
change the volume) fails its solve in every mode, and leaves every field of
the port's volume (the brick table, pool and counters too) as it was, bit
for bit.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dense_visual_odometry_torch.camera import CameraModel as TCamera
from dense_visual_odometry_torch.config import RobustDVOConfig as TConfig
from dense_visual_odometry_torch.io import synthetic
from dense_visual_odometry_torch.models import brick_tsdf as tbrick
from dense_visual_odometry_torch.models import frame_to_model as tf2m
from dense_visual_odometry_torch.models import tsdf as ttsdf
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.config import RobustDVOConfig as JConfig
from dense_visual_odometry_tpu.models import brick_tsdf as jbrick
from dense_visual_odometry_tpu.models import frame_to_model as jf2m
from dense_visual_odometry_tpu.models import tsdf as jtsdf
from dense_visual_odometry_tpu.utils.lie import se3 as jse3

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "tpu_fast.json"
H, W, N_FRAMES, BAND = 120, 160, 6, 16
CENTER, EXTENT, RES = (0.0, 0.0, 1.7), 3.2, 128
ATOL_M, ATOL_RAD = 1e-5, 1e-5
TRUTH_ATOL_M = 0.03  # the reference's own error here is 11-23 mm
MODES = {
    "keyframe_splat": (False, "splat", False),
    "kinfu_march": (True, "march", False),
    "kinfu_brick": (True, "march", True),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: thousands of small CPU ops, which the suite's
    parallel workers would otherwise thrash over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    # The texture of a 60x80 scene, upsampled: cells of 4-20 pixels.
    coarse, _, _ = synthetic.textured_scene(H // 2, W // 2, seed=0)
    gray = F.interpolate(torch.tensor(coarse)[None, None], size=(H, W), mode="bilinear",
                         align_corners=False)[0, 0].numpy()
    _, depth, k = synthetic.textured_scene(H, W, seed=0)
    poses = synthetic.handheld_trajectory(N_FRAMES, seed=0)
    grays, depths = synthetic.render_sequence(gray, depth, k, poses)
    for d in depths:
        d[:BAND], d[-BAND:], d[:, :BAND], d[:, -BAND:] = 0, 0, 0, 0
    return k, grays, depths


def volume_config(pkg_tsdf, pkg_brick, brick):
    kw = dict(truncation=4.0 * EXTENT / RES)
    if brick:
        return pkg_brick.BrickTSDFConfig.around(CENTER, EXTENT, resolution=RES, pool_size=1024,
                                                active_bricks=1024, **kw)
    return pkg_tsdf.TSDFConfig.around(CENTER, EXTENT, resolution=RES, **kw)


def trackers(k, mode):
    every_frame, raycast, brick = MODES[mode]
    data = json.loads(CONFIG.read_text())
    jt = jf2m.FrameToModelTracker(
        JCamera.create(k, 1.0), JConfig.from_dict(data), volume_config(jtsdf, jbrick, brick),
        policy=jf2m.ModelTrackerPolicy(render_every_frame=every_frame, raycast=raycast))
    tt = tf2m.FrameToModelTracker(
        TCamera.create(k, 1.0), TConfig.from_dict(data), volume_config(ttsdf, tbrick, brick),
        policy=tf2m.ModelTrackerPolicy(render_every_frame=every_frame, raycast=raycast),
        device="cpu")
    return jt, tt


def rotation_gap(a, b) -> float:
    rel = np.linalg.inv(a) @ b
    return float(np.linalg.norm(np.asarray(jse3.log(jnp.asarray(rel, jnp.float32)))[3:]))


def end_to_end(scene, mode):
    """Each package's tracker over the scene: the same renders and failed
    solves, trajectories within ``ATOL_M`` and ``ATOL_RAD`` of each other and
    within ``TRUTH_ATOL_M`` of the truth."""
    k, grays, depths = scene
    jt, tt = trackers(k, mode)
    for g, d in zip(grays, depths):
        jt.step(g, d)
        tt.step(g, d)
    assert (tt.renders, tt.failures) == (jt.renders, jt.failures)
    assert tt.failures == 0 and tt.renders >= 1
    tp, tj = tt.trajectory(), jt.trajectory()
    assert tp.shape == tj.shape == (N_FRAMES, 4, 4)
    t_gap = np.abs(tp[:, :3, 3] - tj[:, :3, 3]).max()
    r_gap = max(rotation_gap(a, b) for a, b in zip(tj, tp))
    print(f"{mode}: {tt.renders} renders; the trajectories part by {t_gap} m, {r_gap} rad")
    assert t_gap <= ATOL_M and r_gap <= ATOL_RAD
    truth = synthetic.handheld_trajectory(N_FRAMES, seed=0)
    gt = np.einsum("ij,njk->nik", np.linalg.inv(truth[0]), truth)
    assert np.abs(tp[:, :3, 3] - gt[:, :3, 3]).max() < TRUTH_ATOL_M


def failed_solve_leaves_the_volume(scene, mode):
    k, grays, depths = scene
    _, tt = trackers(k, mode)
    for g, d in zip(grays[:3], depths[:3]):
        tt.step(g, d)
    before = [t.clone() for t in tt.volume]
    poses = len(tt.frame_poses)
    tt.step(np.full_like(grays[3], np.nan), depths[3])
    assert tt.failures == 1 and len(tt.frame_poses) == poses + 1
    np.testing.assert_array_equal(tt.frame_poses[-1], tt.frame_poses[-2])
    for name, old, new in zip(tt.volume._fields, before, tt.volume):
        assert torch.equal(old, new), name


# One mode a file (the other two: test_torch_frame_to_model_{kinfu,brick}.py),
# so that each file's JAX tracker compile stays alone in it.
MODE = "keyframe_splat"


def test_tracks_like_jax(scene):
    end_to_end(scene, MODE)


def test_failed_solve_leaves_the_volume(scene):
    failed_solve_leaves_the_volume(scene, MODE)
