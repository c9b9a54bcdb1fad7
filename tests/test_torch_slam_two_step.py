"""The port's two-step ``SlamSession`` against the JAX package's, on the CPU.

``test_torch_slam.py``'s scene, configuration and policy with
``two_step_tracking``: each frame is solved against the previous frame,
then refined against the keyframe under the per-level caps, the policy's
default (6, 4, 3, 3) cut to the three levels, and under caps (4, 3, 2)
(``--slam-refine-caps`` of the benchmark CLI).  The same checks as there:
identical keyframes, edges, loop closures and relocalizations, every
decision at least 10% from its threshold, packs and edge measurements
within 1e-5, the poses the pose graph moves within 5e-5
(``test_torch_slam.BA_ATOL``).
After a blank frame the previous frame has no depth: step 1 fails and the
refinement starts from the composed constant-velocity seed in both
packages.
"""

import numpy as np
import pytest

from dense_visual_odometry_torch.models import slam as tslam
from tests.test_torch_slam import (
    ATOL,
    BA_ATOL,
    N_BLANK,
    N_SWEEP,
    assert_clear_of_thresholds,
    assert_same_graph,
    one_torch_thread,  # noqa: F401  (autouse)
    run_scenario,
    scenario,
)

VARIANTS = {"default_caps": {}, "caps_4_3_2": {"refine_max_iterations": (4, 3, 2)}}


@pytest.fixture(scope="module")
def runs():
    k, frames, _ = scenario()
    out = {}
    for name, kw in VARIANTS.items():
        policy = {"two_step_tracking": True, **kw}
        out[name] = {pkg: run_scenario(pkg, k, frames, **policy)["front_end"]
                     for pkg in ("jax", "port")}
        out[name]["policy"] = policy
    return out


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_graph_matches_jax(runs, name):
    assert_same_graph(runs[name]["port"], runs[name]["jax"])


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_poses_match_jax(runs, name):
    t, j = runs[name]["port"], runs[name]["jax"]
    np.testing.assert_allclose(t["edges_meas"], j["edges_meas"], atol=ATOL)
    for key in ("frame_poses", "keyframe_poses", "trajectory"):
        np.testing.assert_allclose(t[key], j[key], atol=BA_ATOL, err_msg=key)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_packs_match_jax(runs, name):
    t = np.stack([p for p, _ in runs[name]["port"]["records"]])
    j = np.stack([p for p, _ in runs[name]["jax"]["records"]])
    for sl in (tslam._PK_TRANSFORM, tslam._PK_XI, tslam._PK_DESC):
        np.testing.assert_allclose(t[:, sl], j[:, sl], atol=ATOL)
    np.testing.assert_array_equal(t[:, tslam._PK_SUCCESS], j[:, tslam._PK_SUCCESS])
    np.testing.assert_allclose(t[:, tslam._PK_ERROR], j[:, tslam._PK_ERROR], rtol=1e-4)


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_decisions_clear_of_thresholds(runs, name, pkg):
    run = runs[name][pkg]
    assert_clear_of_thresholds(run["records"], run["loop_closures"], runs[name]["policy"])


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_two_step_exercises_the_back_end(runs, name):
    t = runs[name]["port"]
    assert len(t["keyframe_indices"]) >= 4 and len(t["loop_closures"]) >= 2
    assert t["relocalizations"] == [(N_SWEEP + N_BLANK, 0)]


def test_caps_change_the_refinement(runs):
    """The caps bound the refinement's iterations: the two variants' poses
    part, each within its own match of the JAX package."""
    a = runs["default_caps"]["port"]["frame_poses"]
    b = runs["caps_4_3_2"]["port"]["frame_poses"]
    assert np.abs(a - b).max() > 1e-6
