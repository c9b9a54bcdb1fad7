"""The port's pose graph against the JAX package's, on the CPU.

Graphs are ``tests/unit/test_distributed.py``'s ``_graph``: K seeded random
poses (twists of scale 0.3), the odometry chain plus random extra edges
with identity information, and a noisy start (twists of scale 0.05 on every
pose but the first).  Tolerances: edge Jacobians within 1e-5 of
``jax.jacfwd`` (entries reach ~1), normal systems within 1e-5 of each
entry's scale, optimized poses within 1e-5 with the same iteration count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.models import posegraph as tpg
from dense_visual_odometry_tpu.models import posegraph as jpg
from tests.unit.test_distributed import _graph
from tests.test_torch_slam import one_torch_thread  # noqa: F401  (autouse)

SEEDS = (0, 1, 2)
# Jitted once at import, so that each shape compiles once in this process.
_jacobians = jax.jit(jax.vmap(jpg._edge_residual_and_jacobians))
_normal_system = jax.jit(jpg.build_normal_system, static_argnums=(2, 3))


def _edges_t(edges: jpg.PoseGraphEdges) -> tpg.PoseGraphEdges:
    return tpg.PoseGraphEdges(*(torch.tensor(np.asarray(x)) for x in edges))


def _graph_case(seed, k=6, extra=5, duplicate=False, padding=0):
    """-> (noisy poses, JAX edges) with optional duplicated edges (the same
    (i, j) twice) and zero-information padding edges (0 -> 0, identity)."""
    gt, noisy, edges = _graph(np.random.default_rng(seed), k=k, extra_edges=extra)
    if duplicate:
        edges = jpg.concat_edges(edges, jax.tree.map(lambda x: x[:3], edges))
    if padding:
        pad = jpg.PoseGraphEdges(
            i=jnp.zeros((padding,), jnp.int32), j=jnp.zeros((padding,), jnp.int32),
            measurement=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (padding, 4, 4)),
            information=jnp.zeros((padding, 6, 6), jnp.float32))
        edges = jpg.concat_edges(edges, pad)
    return np.asarray(noisy), edges


@pytest.mark.parametrize("seed", SEEDS)
def test_edge_jacobians_match_jacfwd(seed):
    poses, edges = _graph_case(seed)
    i, j = np.asarray(edges.i), np.asarray(edges.j)
    want = _jacobians(jnp.asarray(poses[i]), jnp.asarray(poses[j]), edges.measurement)
    got = tpg.edge_residuals_and_jacobians(
        torch.tensor(poses[i]), torch.tensor(poses[j]), torch.tensor(np.asarray(edges.measurement)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert np.abs(np.asarray(want[1])).max() > 0.5  # entries of order 1


@pytest.mark.parametrize("robust_delta", [None, 0.3], ids=["quadratic", "geman_mcclure"])
@pytest.mark.parametrize("duplicate, padding", [(False, 0), (True, 4)],
                         ids=["plain", "duplicates_and_padding"])
def test_normal_system_matches_jax(robust_delta, duplicate, padding):
    poses, edges = _graph_case(0, duplicate=duplicate, padding=padding)
    k = poses.shape[0]
    want = _normal_system(jnp.asarray(poses), edges, k, robust_delta)
    got = tpg.build_normal_system(torch.tensor(poses), _edges_t(edges), k, robust_delta)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * max(1.0, np.abs(w).max()))


def test_padding_adds_nothing():
    poses, edges = _graph_case(1)
    _, padded = _graph_case(1, padding=6)
    k = poses.shape[0]
    a = tpg.build_normal_system(torch.tensor(poses), _edges_t(edges), k)
    b = tpg.build_normal_system(torch.tensor(poses), _edges_t(padded), k)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("robust_delta", [None, 0.3], ids=["quadratic", "geman_mcclure"])
@pytest.mark.parametrize("seed", SEEDS)
def test_optimize_matches_jax(seed, robust_delta):
    poses, edges = _graph_case(seed)
    want = jpg.optimize_pose_graph(jnp.asarray(poses), edges, max_iterations=10,
                                   robust_delta=robust_delta)
    got = tpg.optimize_pose_graph(torch.tensor(poses), _edges_t(edges), max_iterations=10,
                                  robust_delta=robust_delta)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=1e-5)
    assert int(got.iterations) == int(want.iterations)
    hist_w = np.asarray(want.chi2_history)
    np.testing.assert_allclose(got.chi2_history.numpy(), hist_w,
                               atol=1e-5 * hist_w[np.isfinite(hist_w)].max())
    assert float(got.chi2) < 1e-6


def test_not_positive_definite_gives_zero_update():
    """A singular Hessian with no damping and no gauge: the JAX package's
    solve returns NaN and ``ok`` False; the port's Cholesky reports the
    failure (no exception) and both give a zero update."""
    k = 2
    hess = np.zeros((k, k, 6, 6), np.float32)
    hess[0, 0] = -np.eye(6)
    rhs = np.ones((k, 6), np.float32)
    gauge = np.zeros((k, 6), np.float32)
    d_j, ok_j = jpg.solve_normal_system(jnp.asarray(hess), jnp.asarray(rhs),
                                        jnp.asarray(gauge), 0.0)
    d_t, ok_t = tpg.solve_normal_system(torch.tensor(hess), torch.tensor(rhs),
                                        torch.tensor(gauge), 0.0)
    assert not bool(ok_j) and not bool(ok_t)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(d_t.numpy(), 0.0)


def test_failed_solve_freezes_the_poses():
    """A graph whose solve fails keeps its poses and stops after the failed
    trip, which the count includes, in both packages."""
    poses, edges = _graph_case(0)
    bad = edges._replace(information=-jnp.asarray(edges.information) * 1e9)
    want = jpg.optimize_pose_graph(jnp.asarray(poses), bad, gauge_weight=0.0)
    got = tpg.optimize_pose_graph(torch.tensor(poses), _edges_t(bad), gauge_weight=0.0)
    assert int(got.iterations) == int(want.iterations) == 1
    np.testing.assert_array_equal(got.poses.numpy(), poses)


def test_chain_and_concat_match_jax():
    rng = np.random.default_rng(4)
    twists = rng.normal(size=(4, 6)).astype(np.float32) * 0.1
    from dense_visual_odometry_tpu.utils.lie import se3 as jse3

    transforms = np.asarray(jax.vmap(jse3.exp)(jnp.asarray(twists)))
    want = jpg.concat_edges(jpg.odometry_chain_edges(jnp.asarray(transforms)),
                            jpg.odometry_chain_edges(jnp.asarray(transforms[:2])))
    got = tpg.concat_edges(tpg.odometry_chain_edges(torch.tensor(transforms)),
                           tpg.odometry_chain_edges(torch.tensor(transforms[:2])))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert got.i.dtype == torch.int32
