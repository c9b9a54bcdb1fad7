"""``BatchedOdometrySession`` of the port against the JAX package's, on
``configs/tpu_accurate.json``.

Two streams of the seeded 120x160 scene of ``test_torch_track.py`` advance
in lockstep for four steps through both packages' sessions: stream 0 takes
frames 0-3, stream 1 frames 4-7.  At step 2 stream 1's frame has no valid
depth, so that stream keeps its pose and reference frame while stream 0
advances; before step 3 stream 0 is reset, so its frame 3 becomes its new
origin.  Poses agree within 1e-5 at every step and the success flags are
equal.  Level 3 of ``tpu_accurate`` stops on an absolute tolerance (see
``test_torch_track_accurate.ITER_GAPS``), and each step starts from the
motion of the last, so the per-level iteration counts (the batch's
largest) part at step 1's level 3, 28 against 23, and at step 3's level
0, 22 against 20 (measured), and are held to those gaps; steps 0 and 2
are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel as TCamera
from dense_visual_odometry_torch.models.batched_session import (
    BatchedOdometrySession as TSession,
)
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.models.batched_session import (
    BatchedOdometrySession as JSession,
)
from tests.test_torch_track import ATOL, scene, tier_configs  # noqa: F401

STEPS = [(0, 4), (1, 5), (2, 6), (3, 7)]
NO_DEPTH = (2, 1)  # (step, stream) whose frame has no valid depth
RESET = (3, 0)  # (step, stream) reset just before that step
ITER_GAPS = (0, 5, 0, 2)  # measured, per step: step 1 at level 3, step 3 at level 0


@pytest.fixture(scope="module")
def runs(scene):  # noqa: F811
    jcfg, tcfg = tier_configs("tpu_accurate")
    jsess = JSession(JCamera.create(scene["k"], 1.0), jcfg, batch=2)
    tsess = TSession(TCamera.create(scene["k"], 1.0), tcfg, batch=2, device="cpu")
    out = {"j": [], "t": [], "j_ok": [], "t_ok": [], "j_its": [], "t_its": []}
    for n, frames in enumerate(STEPS):
        grays = np.stack([scene["grays"][f] for f in frames])
        depths = np.stack([scene["depths"][f] for f in frames])
        if n == NO_DEPTH[0]:
            depths[NO_DEPTH[1]] = 0.0
        if n == RESET[0]:
            jsess.reset_stream(RESET[1])
            tsess.reset_stream(RESET[1])
        out["j"].append(np.asarray(jsess.step(jnp.asarray(grays), jnp.asarray(depths))))
        out["t"].append(tsess.step(torch.tensor(grays), torch.tensor(depths)).numpy())
        out["j_ok"].append(np.asarray(jsess.last_output.success))
        out["t_ok"].append(tsess.last_output.success.numpy())
        out["j_its"].append(np.asarray(jsess.last_output.result.diagnostics.iterations))
        out["t_its"].append(tsess.last_output.result.diagnostics.iterations.numpy())
    return {k: np.stack(v) for k, v in out.items()}


def test_batched_session_matches_jax(runs):
    np.testing.assert_allclose(runs["t"], runs["j"], atol=ATOL)
    np.testing.assert_array_equal(runs["t_ok"], runs["j_ok"])
    gaps = np.abs(runs["t_its"].astype(int) - runs["j_its"].astype(int)).max(axis=1)
    assert (gaps <= np.asarray(ITER_GAPS)).all(), gaps


def test_failed_and_reset_streams(runs, scene):  # noqa: F811
    poses, ok = runs["t"], runs["t_ok"]
    step, stream = NO_DEPTH
    assert not ok[step, stream] and ok[step, 1 - stream]
    np.testing.assert_array_equal(poses[step, stream], poses[step - 1, stream])
    step, stream = RESET
    np.testing.assert_array_equal(poses[step, stream], np.eye(4, dtype=np.float32))
    # Stream 1 tracks frame 7 against frame 5, its last good frame.
    gt = np.linalg.inv(scene["poses"][4]) @ scene["poses"][7]
    assert np.abs(poses[3, 1, :3, 3] - gt[:3, 3]).max() < 5e-3
