"""``OdometrySession`` of the port against the JAX package's, on ``configs/tpu_fast.json``.

Five frames of the seeded 120x160 scene of ``test_torch_track.py`` (its
border band of invalid depth included) go through both packages' sessions:
the constant-velocity warm start, the robust init selection and the state
commit run as a user drives them.  Poses agree within 1e-5 and the per-level
iteration counts are identical.  The port also resumes from the JAX
session's state after the third frame (``session_state_from_numpy``) and
must continue exactly as the JAX session does.
"""

import jax
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel as TCamera
from dense_visual_odometry_torch.config import RobustDVOConfig as TConfig
from dense_visual_odometry_torch.models import session as tsession
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.config import RobustDVOConfig as JConfig
from dense_visual_odometry_tpu.models.session import OdometrySession as JSession
from tests.test_torch_track import ATOL, CONFIGS, scene  # noqa: F401


@pytest.fixture(scope="module")
def session_runs(scene):  # noqa: F811
    """Five frames through both packages' sessions on tpu_fast; the port also
    resumes from the JAX session's state after frame 3."""
    path = CONFIGS / "tpu_fast.json"
    jcam = JCamera.create(scene["k"], 1.0)
    tcam = TCamera.create(scene["k"], 1.0)
    jsess = JSession(jcam, JConfig.from_json(path))
    tsess = tsession.OdometrySession(tcam, TConfig.from_json(path), device="cpu")
    frames = list(zip(scene["grays"][:5], scene["depths"][:5]))
    jposes, tposes, jits, tits, handoff = [], [], [], [], None
    for n, (g, d) in enumerate(frames):
        jposes.append(np.asarray(jsess.step(g, d).matrix))
        jits.append(np.asarray(jsess.last_output.result.diagnostics.iterations))
        tposes.append(tsess.step(g, d).matrix.numpy())
        tits.append(tsess.last_output.result.diagnostics.iterations.numpy())
        if n == 2:
            handoff = jax.tree.map(np.asarray, jsess._state)
    resumed = tsession.session_state_from_numpy(handoff, "cpu")
    cfg = TConfig.from_json(path)
    rposes = []
    for g, d in frames[3:]:
        resumed, out = tsession.session_step(
            resumed, g, d, tcam, torch.eye(4), cfg, use_cv_guess=True
        )
        rposes.append(out.pose.numpy())
    return dict(j=np.stack(jposes), t=np.stack(tposes), jits=jits, tits=tits,
                resumed=np.stack(rposes), success=bool(tsess.last_output.success))


def test_session_matches_jax(session_runs):
    r = session_runs
    assert r["success"]
    np.testing.assert_allclose(r["t"], r["j"], atol=ATOL)
    for a, b in zip(r["tits"], r["jits"]):
        np.testing.assert_array_equal(a.reshape(-1), b.reshape(-1))
    np.testing.assert_allclose(r["resumed"], r["j"][3:], atol=ATOL)


def test_session_tracks_truth(session_runs, scene):  # noqa: F811
    gt = np.einsum("ij,njk->nik", np.linalg.inv(scene["poses"][0]), scene["poses"][:5])
    assert np.abs(session_runs["t"][:, :3, 3] - gt[:, :3, 3]).max() < 5e-3

