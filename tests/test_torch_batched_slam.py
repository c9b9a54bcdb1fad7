"""The port's ``BatchedSlamSession`` against its own ``SlamSession`` and the
JAX package's ``BatchedSlamSession``, on the CPU.

Two streams of ``test_torch_slam.py``'s scene (stream 1 on the source
frame of seed 3) advance in lockstep under its configuration and policy:
promotions, loop closures, and at the same step both streams lose track
and relocalize, so the grouped verification batch
(``n_streams * loop_max_candidates`` rows) serves both.  The
configuration has no hard-motion trigger, so no batch-global branch
couples the streams.  Each stream equals a ``SlamSession`` of the port on
its frames (keyframes, loop closures and relocalizations identical, poses
within ``test_torch_slam.BA_ATOL``, 5e-5: a batch of two rounds apart from
a batch of one in the tracker's sums, and the pose graph carries it) and
the JAX package's batched stream (the same).  The two-step variant is
held against the port's own sessions over the sweep.
"""

import numpy as np
import pytest

from dense_visual_odometry_torch.camera import CameraModel as TCamera
from dense_visual_odometry_torch.models import batched_slam as tbs
from dense_visual_odometry_torch.models import slam as tslam
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.models import batched_slam as jbs
from dense_visual_odometry_tpu.models import slam as jslam
from tests.test_torch_slam import (
    BA_ATOL,
    N_BLANK,
    N_SWEEP,
    POLICY,
    assert_same_graph,
    configs,
    make_session,
    one_torch_thread,  # noqa: F401  (autouse)
    scenario,
    snapshot,
)

SEEDS = (0, 3)


def _streams():
    scenes = [scenario(seed) for seed in SEEDS]
    k = scenes[0][0]
    assert all(np.array_equal(s[0], k) for s in scenes)
    return k, [s[1] for s in scenes]


def _batched(pkg, k, streams, **policy_kw):
    jcfg, tcfg = configs()
    kw = {**POLICY, **policy_kw}
    if pkg == "jax":
        sess = jbs.BatchedSlamSession(JCamera.create(k, 1.0), jcfg, n_streams=len(streams),
                                      policy=jslam.KeyframePolicy(**kw))
    else:
        sess = tbs.BatchedSlamSession(TCamera.create(k, 1.0), tcfg, n_streams=len(streams),
                                      policy=tslam.KeyframePolicy(**kw), device="cpu")
    for s in sess.sessions:
        s.records = []
    for t in range(len(streams[0])):
        sess.step([s[t][0] for s in streams], [s[t][1] for s in streams])
    return sess


@pytest.fixture(scope="module")
def runs():
    k, streams = _streams()
    out = {"batched": {pkg: _batched(pkg, k, streams) for pkg in ("jax", "port")},
           "single": []}
    for frames in streams:
        sess = make_session("port", k)
        for g, d in frames:
            sess.step(g, d)
        out["single"].append(sess)
    # Two-step over the sweep alone (its promotions and loop closures).
    sweeps = [frames[:N_SWEEP] for frames in streams]
    out["two_step"] = _batched("port", k, sweeps, two_step_tracking=True)
    out["two_step_single"] = []
    for frames in sweeps:
        sess = make_session("port", k, two_step_tracking=True)
        for g, d in frames:
            sess.step(g, d)
        out["two_step_single"].append(sess)
    return out


@pytest.mark.parametrize("b", range(len(SEEDS)))
def test_stream_matches_single_session(runs, b):
    got, want = snapshot(runs["batched"]["port"].sessions[b]), snapshot(runs["single"][b])
    assert_same_graph(got, want)
    np.testing.assert_allclose(got["frame_poses"], want["frame_poses"], atol=BA_ATOL)
    np.testing.assert_allclose(got["trajectory"], want["trajectory"], atol=BA_ATOL)


@pytest.mark.parametrize("b", range(len(SEEDS)))
def test_stream_matches_jax(runs, b):
    got = snapshot(runs["batched"]["port"].sessions[b])
    want = snapshot(runs["batched"]["jax"].sessions[b])
    assert_same_graph(got, want)
    np.testing.assert_allclose(got["frame_poses"], want["frame_poses"], atol=BA_ATOL)
    np.testing.assert_allclose(got["trajectory"], want["trajectory"], atol=BA_ATOL)


@pytest.mark.parametrize("b", range(len(SEEDS)))
def test_two_step_stream_matches_single_session(runs, b):
    got = snapshot(runs["two_step"].sessions[b])
    want = snapshot(runs["two_step_single"][b])
    assert_same_graph(got, want)
    assert len(got["keyframe_indices"]) >= 3 and got["loop_closures"]
    np.testing.assert_allclose(got["frame_poses"], want["frame_poses"], atol=BA_ATOL)


def test_streams_relocalize_together(runs):
    """Both streams relocalize at the revisit, in one grouped batch, and
    track apart (their scenes differ)."""
    sessions = runs["batched"]["port"].sessions
    for s in sessions:
        assert s.relocalizations == [(N_SWEEP + N_BLANK, 0)]
        assert s.num_keyframes >= 4 and len(s.loop_closures) >= 2
    assert runs["batched"]["port"].num_keyframes == [s.num_keyframes for s in sessions]
    a, b = (np.stack(s.frame_poses) for s in sessions)
    assert np.abs(a - b).max() > 1e-4


def test_keyframe_tree_follows_promotions(runs):
    """The stacked keyframe tree holds each stream's active keyframe."""
    bat = runs["batched"]["port"]
    for b, s in enumerate(bat.sessions):
        for lv, g in enumerate(s._keyframe.gray):
            np.testing.assert_array_equal(bat._keyframes.gray[lv][b].numpy(), g.numpy())


def test_slice_is_a_copy():
    """``_slice_stream`` returns a copy: writing the stacked tree in place
    (``_set_stream``) leaves earlier slices as they were."""
    import torch

    from dense_visual_odometry_torch.models.robust import FrameData

    tree = FrameData(gray=(torch.zeros(2, 4, 4),), depth_m=(torch.zeros(2, 4, 4),))
    piece = tbs._slice_stream(tree, 1)
    tbs._set_stream(tree, FrameData(gray=(torch.ones(4, 4),), depth_m=(torch.ones(4, 4),)), 1)
    assert float(tree.gray[0][1].sum()) == 16.0 and float(piece.gray[0].sum()) == 0.0
    assert float(tree.gray[0][0].sum()) == 0.0


def test_wrong_batch_raises():
    k, _ = _streams()
    _, tcfg = configs()
    sess = tbs.BatchedSlamSession(TCamera.create(k, 1.0), tcfg, n_streams=2, device="cpu")
    with pytest.raises(ValueError, match="expected 2 frames"):
        sess.step([np.zeros((4, 4))], [np.zeros((4, 4))])
