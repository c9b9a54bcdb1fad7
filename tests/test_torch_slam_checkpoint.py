"""SLAM checkpoints across the two packages, on the CPU.

``test_torch_slam.py``'s scene, configuration and policy.  A session of
one package runs the first ``SPLIT`` frames (through the relocalization
and the return's first promotion), is saved with its package's
``save_slam_session``, and a fresh session of the other package loads the
file and runs the remaining frames; so does a fresh session of the same
package.  Every resumed session equals the uninterrupted run of the
package that resumed it: the same keyframes, loop closures and
relocalizations, frame poses within ``test_torch_slam.BA_ATOL``; within
one package bit for bit.
Descriptors are recomputed on load; the loaded state (keys, graph,
pyramids) equals the saved one.
"""

import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel as TCamera
from dense_visual_odometry_torch.io import checkpoint as tckpt
from dense_visual_odometry_torch.models import slam as tslam
from dense_visual_odometry_torch.models.session import OdometrySession as TSession
from dense_visual_odometry_tpu.io import checkpoint as jckpt
from tests.test_torch_slam import (  # noqa: F401  (one_torch_thread is autouse)
    BA_ATOL,
    N_BLANK,
    N_SWEEP,
    configs,
    make_session,
    one_torch_thread,
    scenario,
)

SPLIT = N_SWEEP + N_BLANK + 3  # saved after the revisit and two returns
LOADERS = {"jax": jckpt, "port": tckpt}


def _continue(sess, frames):
    for g, d in frames:
        sess.step(g, d)
    return sess


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> {(saved by, resumed by): session} plus the uninterrupted runs
    {("full", pkg): session} and the checkpoint files."""
    k, frames, _ = scenario()
    root = tmp_path_factory.mktemp("slam_ckpt")
    out, files = {}, {}
    for pkg in ("jax", "port"):
        sess = _continue(make_session(pkg, k), frames[:SPLIT])
        files[pkg] = LOADERS[pkg].save_slam_session(root / f"{pkg}.npz", sess)
        out[("saved", pkg)] = {
            "keyframe_indices": list(sess.keyframe_indices),
            "kf_desc": [np.array(d) for d in sess._kf_desc],
            "frame_poses": np.stack(sess.frame_poses),
        }
        out[("full", pkg)] = _continue(sess, frames[SPLIT:])
    for saver in ("jax", "port"):
        for loader in ("jax", "port"):
            fresh = make_session(loader, k)
            LOADERS[loader].load_slam_session(files[saver], fresh)
            out[("loaded", saver, loader)] = {
                "kf_desc": [np.array(d) for d in fresh._kf_desc],
                "frame_poses": np.stack(fresh.frame_poses),
                "keyframe_indices": list(fresh.keyframe_indices),
                "prev_fd": fresh._prev_fd,
            }
            out[(saver, loader)] = _continue(fresh, frames[SPLIT:])
    out["files"] = files
    return out


PAIRS = [("jax", "port"), ("port", "jax"), ("port", "port"), ("jax", "jax")]


@pytest.mark.parametrize("saver, loader", PAIRS, ids=[f"{a}_to_{b}" for a, b in PAIRS])
def test_resume_matches_uninterrupted_run(runs, saver, loader):
    got, want = runs[(saver, loader)], runs[("full", loader)]
    assert got.keyframe_indices == want.keyframe_indices
    assert [(a, b) for a, b, _ in got.loop_closures] == [(a, b) for a, b, _ in want.loop_closures]
    assert got.relocalizations == want.relocalizations
    atol = 0.0 if saver == loader else BA_ATOL
    np.testing.assert_allclose(np.stack(got.frame_poses), np.stack(want.frame_poses), atol=atol)
    np.testing.assert_allclose(got.optimized_trajectory(), want.optimized_trajectory(), atol=atol)


@pytest.mark.parametrize("saver, loader", PAIRS, ids=[f"{a}_to_{b}" for a, b in PAIRS])
def test_loaded_state_equals_saved(runs, saver, loader):
    saved, loaded = runs[("saved", saver)], runs[("loaded", saver, loader)]
    assert loaded["keyframe_indices"] == saved["keyframe_indices"]
    np.testing.assert_array_equal(loaded["frame_poses"], saved["frame_poses"])
    for a, b in zip(loaded["kf_desc"], saved["kf_desc"]):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert loaded["prev_fd"] is None


def test_files_have_the_same_keys(runs):
    with np.load(runs["files"]["jax"]) as j, np.load(runs["files"]["port"]) as t:
        assert sorted(j.files) == sorted(t.files)
        for key in j.files:
            assert j[key].shape == t[key].shape, key
            assert j[key].dtype.kind == t[key].dtype.kind, key
        assert str(t["kind"]) == "slam" and int(t["version"]) == tckpt.FORMAT_VERSION


def test_port_resume_stays_on_its_device(runs):
    sess = runs[("jax", "port")]
    assert all(fd is None or fd.gray[0].device == torch.device("cpu") for fd in sess._kf_frames)


def test_rejects_bad_checkpoints(tmp_path):
    k, frames, _ = scenario()
    empty = make_session("port", k)
    with pytest.raises(ValueError, match="no keyframes"):
        tckpt.save_slam_session(tmp_path / "empty.npz", empty)
    one = _continue(make_session("port", k), frames[:1])
    path = tckpt.save_slam_session(tmp_path / "one.npz", one)
    _, tcfg = configs()
    two_levels = tslam.SlamSession(TCamera.create(k, 1.0), tcfg.__class__(levels=2),
                                   device="cpu")
    with pytest.raises(ValueError, match="pyramid levels"):
        tckpt.load_slam_session(path, two_levels)
    odo = TSession(TCamera.create(k, 1.0), tcfg, device="cpu")
    odo.step(*frames[0])
    odo_path = tckpt.save_session(tmp_path / "odo.npz", odo)
    with pytest.raises(KeyError):
        tckpt.load_slam_session(odo_path, make_session("port", k))
