"""The port's ``SlamSession`` against the JAX package's, on the CPU.

The scene (:func:`scenario`): the seeded 96x128 synthetic source frame
(``io.synthetic.textured_scene``), rendered along a sweep of 8 frames that
yaws 0.04 rad and moves 11 mm a frame (promotions on rotation, loop
closures between keyframes that still overlap), then 3 blank frames (no
image, no depth: lost through the error gate), a view 5 mm from the start
(tracked against the yawed-away keyframe it fails the error gate, so the
session relocalizes at keyframe 0), and the poses of sweep frames 1-4
again, 3 mm lower (returns to earlier views: promotions and more loop
closures).  Depth is invalid in an 8-pixel border band, as in
``test_torch_track.py``: under a near-identity warp a border pixel
projects onto the bounds test's edge, where XLA:CPU's fused multiply-adds
and PyTorch's rounding decide its validity apart.

Both packages run the same frames under one configuration, a three-level
LM tracker without the Pallas kernels (:data:`CFG`; ``tpu_slam``'s tracker
is held against the JAX package in ``test_torch_track_slam.py``, and its
kernels' interpret-mode compiles would cost a minute a program here), and
one policy (:data:`POLICY`).  Keyframe indices, edges, loop closures and
relocalizations are identical; each step's transform and the edge
measurements agree within 1e-5, every pose that the pose graph moves
(frame and keyframe poses, optimized trajectories, the dense refinement's
poses) within :data:`BA_ATOL` (5e-5, it says why), the dense refinement's
chi2 within 1e-4 relative and its depths within :data:`DEPTH_RTOL`.
Every keyframe decision of the scene (translation, rotation and valid
ratio against the policy's thresholds, the error gate, the loop closures'
errors) sits at least 10% away from its threshold, so a parting decision
points at the port, not at the scene.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel as TCamera
from dense_visual_odometry_torch.config import RobustDVOConfig as TConfig
from dense_visual_odometry_torch.io import synthetic
from dense_visual_odometry_torch.models import slam as tslam
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.config import RobustDVOConfig as JConfig
from dense_visual_odometry_tpu.models import slam as jslam

H, W = 96, 128
ATOL = 1e-5  # the tracker's outputs: each step's transform, edge measurements
# Poses that the pose graph has moved (frame and keyframe poses, optimized
# trajectories).  The edges' information (the tracker's Hessians) has traces
# of ~6e10 here, and the float32 Cholesky of each Gauss-Newton step leaves
# the graph's poses jittering around its optimum in either package: fed the
# same edges and poses, the two packages' graphs part by 4.1e-6 after 20
# iterations, chi2 wandering by 0.1 around 2,296 without meeting the 1e-9
# tolerance (measured).  After a session's window BAs the poses part by up
# to 6e-6 here, 1.2e-5 in the two-step runs and 1.6e-5 in a batched stream
# (``test_torch_slam_two_step.py``, ``test_torch_batched_slam.py``).
BA_ATOL = 5e-5
# The dense refinement's inverse depths: each update is the Schur
# back-substitution of the pose step through the coupling y, and on this
# scene they part by up to 2.7e-3 relative after the 8 iterations (the
# refined full-resolution depths by 1.0e-3 m; measured); on the planar
# scenes of test_torch_dense_ba.py they agree within 1e-4.
DEPTH_RTOL = 5e-3
CFG = dict(levels=3, use_weighter=True, lm_lambda0=1e-4)
POLICY = synthetic.REVISIT_POLICY
N_SWEEP, N_BLANK = synthetic.REVISIT_SWEEP, synthetic.REVISIT_BLANK
BAND = 8  # pixels of invalid depth along the border (see scenario)
MARGIN = 0.1  # every decision at least 10% away from its threshold


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module.  The SLAM runs here are thousands
    of small CPU ops; with the suite's parallel workers each spreading them
    over every core the workers thrash (measured with six workers: these
    files' fixtures took 4-5 times their single-process time, 86 s in all
    with one thread against 279 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scenario(seed: int = 0):
    """-> (intrinsics, [(gray, depth_m)], [truth or None]): the sweep, the
    blank frames, the revisit of the start and the sweep's frames 1-4
    (``synthetic.revisit_sequence``, which the smoke's phase 6 runs at
    640x480)."""
    return synthetic.revisit_sequence(H, W, seed=seed, band=BAND)


def configs():
    return JConfig(**CFG), TConfig(**CFG)


def make_session(pkg: str, k, policy=None, **policy_kw):
    """A ``SlamSession`` of the JAX package (``pkg`` "jax") or of the port
    on the CPU, recording every step's ``_PK_*`` pack and the keyframe's
    valid count it is judged against (``session.records``)."""
    jcfg, tcfg = configs()
    kw = {**POLICY, **policy_kw}
    if pkg == "jax":
        sess = jslam.SlamSession(JCamera.create(k, 1.0), jcfg, jslam.KeyframePolicy(**kw))
    else:
        sess = tslam.SlamSession(TCamera.create(k, 1.0), tcfg, tslam.KeyframePolicy(**kw),
                                 device="cpu")
    sess.records = []
    apply_step = sess.apply_step

    def recording(fd_thunk, pack, reloc_thunk=None):
        sess.records.append((np.array(pack), sess._kf_valid_count))
        return apply_step(fd_thunk, pack, reloc_thunk)

    sess.apply_step = recording
    return sess


def snapshot(sess) -> dict:
    """The session's host state, copied."""
    return {
        "keyframe_indices": list(sess.keyframe_indices),
        "edges": (list(sess._edges_i), list(sess._edges_j)),
        "edges_meas": np.stack(sess._edges_meas),
        "edges_info": np.stack(sess._edges_info),
        "loop_closures": list(sess.loop_closures),
        "relocalizations": list(sess.relocalizations),
        "frame_poses": np.stack(sess.frame_poses),
        "keyframe_poses": np.stack(sess.keyframe_poses),
        "trajectory": sess.optimized_trajectory(),
        "records": list(sess.records),
    }


def run_scenario(pkg: str, k, frames, **policy_kw) -> dict:
    sess = make_session(pkg, k, **policy_kw)
    for g, d in frames:
        sess.step(g, d)
    return {"session": sess, "front_end": snapshot(sess)}


def decision_margins(records, policy_kw=None) -> list:
    """Every decision of a run as (what, value / threshold): the error gate
    on each solve that succeeded, then on each frame that passed it the
    translation, rotation and valid-ratio tests."""
    pol = dataclasses.asdict(tslam.KeyframePolicy(**{**POLICY, **(policy_kw or {})}))
    out = []
    for pack, kf_valid in records:
        if pack[tslam._PK_SUCCESS] <= 0.5:
            continue
        out.append(("error", pack[tslam._PK_ERROR] / pol["track_max_error"]))
        if pack[tslam._PK_ERROR] > pol["track_max_error"]:
            continue
        xi = pack[tslam._PK_XI]
        out.append(("translation", np.linalg.norm(xi[:3]) / pol["max_translation"]))
        out.append(("rotation", np.linalg.norm(xi[3:]) / pol["max_rotation"]))
        out.append(("valid_ratio", pack[tslam._PK_VALID] / kf_valid / pol["min_valid_ratio"]))
    return out


def assert_clear_of_thresholds(records, loop_closures, policy_kw=None):
    for what, ratio in decision_margins(records, policy_kw):
        assert abs(ratio - 1.0) >= MARGIN, (what, ratio)
    for _, _, err in loop_closures:
        assert err <= (1.0 - MARGIN) * jslam.KeyframePolicy().loop_max_error


def assert_same_graph(t: dict, j: dict):
    assert t["keyframe_indices"] == j["keyframe_indices"]
    assert t["edges"] == j["edges"]
    assert [(a, b) for a, b, _ in t["loop_closures"]] == [(a, b) for a, b, _ in j["loop_closures"]]
    np.testing.assert_allclose([e for _, _, e in t["loop_closures"]],
                               [e for _, _, e in j["loop_closures"]], rtol=1e-3)
    assert t["relocalizations"] == j["relocalizations"]


@pytest.fixture(scope="module")
def scene():
    return scenario()


@pytest.fixture(scope="module")
def runs(scene):
    """Both packages over the scene, then ``optimize_full``, then
    ``refine_dense(update_depths=True)`` (grid stride 8)."""
    k, frames, _ = scene
    out = {}
    for pkg in ("jax", "port"):
        run = run_scenario(pkg, k, frames)
        sess = run["session"]
        sess.optimize_full()
        run["full"] = snapshot(sess)
        run["dense"] = sess.refine_dense(update_depths=True)
        run["refined"] = snapshot(sess)
        run["depths"] = [None if fd is None else [np.asarray(d) for d in fd.depth_m]
                         for fd in sess._kf_frames]
        out[pkg] = run
    return out


def test_scene_exercises_the_back_end(runs, scene):
    """At least four keyframes (the window BA runs), loop closures, one
    relocalization at keyframe 0 on the revisit, and front-end poses within
    12 mm of the truth on every tracked frame."""
    fe = runs["port"]["front_end"]
    assert len(fe["keyframe_indices"]) >= 4
    assert len(fe["loop_closures"]) >= 2
    assert fe["relocalizations"] == [(N_SWEEP + N_BLANK, 0)]
    est = fe["frame_poses"]
    for n, gt in enumerate(scene[2]):
        if gt is not None:
            assert np.linalg.norm(est[n, :3, 3] - gt[:3, 3]) < 0.012, n


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_decisions_clear_of_thresholds(runs, pkg):
    fe = runs[pkg]["front_end"]
    assert_clear_of_thresholds(fe["records"], fe["loop_closures"])
    # The blank frames and the revisit fail the error gate, nothing else.
    lost = [n + 1 for n, (p, _) in enumerate(fe["records"])
            if p[tslam._PK_ERROR] > POLICY["track_max_error"]]
    assert lost == list(range(N_SWEEP, N_SWEEP + N_BLANK + 1))


def test_graph_matches_jax(runs):
    assert_same_graph(runs["port"]["front_end"], runs["jax"]["front_end"])


def test_frame_poses_match_jax(runs):
    np.testing.assert_allclose(runs["port"]["front_end"]["frame_poses"],
                               runs["jax"]["front_end"]["frame_poses"], atol=BA_ATOL)


def test_window_ba_matches_jax(runs):
    """The keyframe poses after the windowed BA of every promotion."""
    np.testing.assert_allclose(runs["port"]["front_end"]["keyframe_poses"],
                               runs["jax"]["front_end"]["keyframe_poses"], atol=BA_ATOL)
    np.testing.assert_allclose(runs["port"]["front_end"]["trajectory"],
                               runs["jax"]["front_end"]["trajectory"], atol=BA_ATOL)


def test_edges_match_jax(runs):
    t, j = runs["port"]["front_end"], runs["jax"]["front_end"]
    np.testing.assert_allclose(t["edges_meas"], j["edges_meas"], atol=ATOL)
    scale = np.abs(j["edges_info"]).max(axis=(1, 2), keepdims=True)
    assert (np.abs(t["edges_info"] - j["edges_info"]) <= 1e-4 * scale).all()


def test_packs_match_jax(runs):
    """Every step's 157-float pack (the host policy's only input)."""
    t = np.stack([p for p, _ in runs["port"]["front_end"]["records"]])
    j = np.stack([p for p, _ in runs["jax"]["front_end"]["records"]])
    assert t.shape == j.shape == (len(runs["jax"]["front_end"]["records"]), tslam._PK_SIZE)
    for name in ("_PK_TRANSFORM", "_PK_XI", "_PK_DESC"):
        sl = getattr(tslam, name)
        np.testing.assert_allclose(t[:, sl], j[:, sl], atol=ATOL, err_msg=name)
    for name in ("_PK_SUCCESS", "_PK_VALID"):
        np.testing.assert_array_equal(t[:, getattr(tslam, name)], j[:, getattr(tslam, name)])
    np.testing.assert_allclose(t[:, tslam._PK_ERROR], j[:, tslam._PK_ERROR], rtol=1e-4)
    hess = j[:, tslam._PK_HESSIAN]
    assert (np.abs(t[:, tslam._PK_HESSIAN] - hess)
            <= 1e-4 * np.abs(hess).max(axis=1, keepdims=True)).all()


def test_pack_layout_matches_jax():
    for name in ("_PK_TRANSFORM", "_PK_SUCCESS", "_PK_ERROR", "_PK_XI", "_PK_VALID",
                 "_PK_HESSIAN", "_PK_DESC", "_PK_SIZE"):
        assert getattr(tslam, name) == getattr(jslam, name), name


def test_optimize_full_matches_jax(runs):
    t, j = runs["port"]["full"], runs["jax"]["full"]
    np.testing.assert_allclose(t["keyframe_poses"], j["keyframe_poses"], atol=BA_ATOL)
    np.testing.assert_allclose(t["trajectory"], j["trajectory"], atol=BA_ATOL)
    # The global BA moves the keyframes.
    assert np.abs(t["keyframe_poses"] - runs["port"]["front_end"]["keyframe_poses"]).max() > 1e-6


def test_refine_dense_matches_jax(runs):
    t, j = runs["port"], runs["jax"]
    np.testing.assert_allclose(t["refined"]["keyframe_poses"], j["refined"]["keyframe_poses"],
                               atol=BA_ATOL)
    np.testing.assert_allclose(t["refined"]["trajectory"], j["refined"]["trajectory"], atol=BA_ATOL)
    np.testing.assert_allclose(t["dense"].inv_depth.numpy(), np.asarray(j["dense"].inv_depth),
                               rtol=DEPTH_RTOL)
    np.testing.assert_allclose(float(t["dense"].chi2), float(j["dense"].chi2), rtol=1e-4)


def test_depth_feedback_matches_jax(runs):
    """``update_depths=True``: every retained keyframe's depth pyramid."""
    for t, j in zip(runs["port"]["depths"], runs["jax"]["depths"]):
        assert (t is None) == (j is None)
        for dt, dj in zip(t or [], j or []):
            np.testing.assert_allclose(dt, dj, rtol=DEPTH_RTOL, atol=1e-6)
    # The feedback changed the depths (the refinement moved them).
    _, frames, _ = scenario()
    assert np.abs(runs["port"]["depths"][0][0] - frames[0][1]).max() > 1e-5


@pytest.mark.parametrize("index", [0, 3, N_SWEEP, N_SWEEP + N_BLANK])
def test_descriptor_matches_jax(scene, index):
    """The place descriptor of a frame's coarsest level (24x32 -> 8x12,
    antialiased), within 1e-6 of the JAX package's; every retained
    keyframe's too."""
    k, frames, _ = scene
    g = frames[index][0]
    coarse = g
    for _ in range(CFG["levels"] - 1):
        coarse = synthetic_pyr_down(coarse)
    want = np.asarray(jslam._frame_descriptor(jnp.asarray(coarse)))
    got = tslam._frame_descriptor(torch.tensor(coarse)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # A blank frame's descriptor is 0, any other one a unit vector.
    assert abs(np.linalg.norm(got) - float(g.any())) < 1e-5


def synthetic_pyr_down(g: np.ndarray) -> np.ndarray:
    """The port's pyramid step (the descriptor reads the coarsest level)."""
    from dense_visual_odometry_torch.ops.pyramid import pyr_down

    return pyr_down(torch.tensor(g)).numpy()


def test_keyframe_descriptors_match_jax(runs):
    for t, j in zip(runs["port"]["session"]._kf_desc, runs["jax"]["session"]._kf_desc):
        np.testing.assert_allclose(t, j, atol=1e-6)


DEGENERATE = {
    "identity": (np.eye(4), True),
    "zero_bottom_row": (np.vstack([np.eye(4)[:3], np.zeros((1, 4))]), False),
    "nan": (np.full((4, 4), np.nan), False),
    "scaled_rotation": (np.diag([2.0, 2.0, 2.0, 1.0]), False),
    "zero": (np.zeros((4, 4)), False),
}


@pytest.mark.parametrize("name", sorted(DEGENERATE))
def test_pose_guards_match_jax(name):
    """``_invertible_pose`` and ``_safe_inv_pose`` give the JAX package's
    answers on degenerate transforms: a bottom row of zeros rejects the
    candidate and a singular one inverts to None, without raising."""
    t, ok = DEGENERATE[name]
    assert tslam._invertible_pose(t) == jslam._invertible_pose(t) == ok
    got, want = tslam._safe_inv_pose(t), jslam._safe_inv_pose(t)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    if name in ("zero_bottom_row", "zero"):
        assert got is None


def test_two_sessions_do_not_share_state(scene):
    """The first frame anchors keyframe 0 at the identity; a fresh session
    of the same policy starts from nothing."""
    k, frames, _ = scene
    a = make_session("port", k)
    pose = a.step(*frames[0])
    np.testing.assert_array_equal(pose.matrix.numpy(), np.eye(4, dtype=np.float32))
    assert a.num_keyframes == 1 and a.keyframe_indices == [0]
    b = make_session("port", k)
    assert b.num_keyframes == 0 and b.optimized_trajectory().shape == (0, 4, 4)
    assert b.refine_dense() is None


def test_default_device_is_the_gpu(scene):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tslam.SlamSession(TCamera.create(scene[0], 1.0))


@pytest.mark.cuda
def test_cuda_matches_cpu(scene, runs):
    """The scene on the card: the same keyframes, loop closures and
    relocalization as on the CPU, poses within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    k, frames, _ = scene
    _, tcfg = configs()
    sess = tslam.SlamSession(TCamera.create(k, 1.0), tcfg, tslam.KeyframePolicy(**POLICY),
                             device="cuda")
    for g, d in frames:
        sess.step(g, d)
    cpu = runs["port"]["front_end"]
    assert sess.keyframe_indices == cpu["keyframe_indices"]
    assert sess.relocalizations == cpu["relocalizations"]
    np.testing.assert_allclose(np.stack(sess.frame_poses), cpu["frame_poses"], atol=1e-4)


def test_config_replace_keeps_two_step_caps():
    """Two-step tracking refines under the policy's caps cut to the
    configuration's levels, in both packages."""
    jcfg, tcfg = configs()
    kw = dict(two_step_tracking=True, refine_max_iterations=(5, 4, 3, 2))
    j = jslam.SlamSession(JCamera.create(np.eye(3), 1.0), jcfg, jslam.KeyframePolicy(**kw))
    t = tslam.SlamSession(TCamera.create(np.eye(3), 1.0), tcfg, tslam.KeyframePolicy(**kw),
                          device="cpu")
    assert t._cfg_refine.max_iterations_per_level == j._cfg_refine.max_iterations_per_level
    assert t._cfg_refine == dataclasses.replace(tcfg, max_iterations_per_level=(5, 4, 3))
