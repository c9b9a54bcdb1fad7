"""The last small public functions of the port against the JAX package's.

``se3.hat``, ``identity``, ``transform_points``, ``adjoint``; ``so3.vee``,
``theta``, ``is_rotation_matrix``, ``wrap_angle``;
``weighting.t_distribution_weights`` and ``weighted_error`` on seeded numpy
inputs, within 1e-6; and ``robust.make_tracker`` (``track_pair`` bound to a
configuration, with the identity as the unset guess and anchor) against the
JAX package's ``make_tracker`` on a seeded 60x80 scene, transforms within
1e-5 and equal iteration counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.config import RobustDVOConfig as TConfig
from dense_visual_odometry_torch.config import TWeighterConfig as TWeighter
from dense_visual_odometry_torch.io import synthetic
from dense_visual_odometry_torch.models import robust as trobust
from dense_visual_odometry_torch.models import weighting as tweighting
from dense_visual_odometry_torch.utils.lie import se3 as tse3
from dense_visual_odometry_torch.utils.lie import so3 as tso3
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.config import RobustDVOConfig as JConfig
from dense_visual_odometry_tpu.config import TWeighterConfig as JWeighter
from dense_visual_odometry_tpu.models import robust as jrobust
from dense_visual_odometry_tpu.models import weighting as jweighting
from dense_visual_odometry_tpu.utils.lie import se3 as jse3
from dense_visual_odometry_tpu.utils.lie import so3 as jso3

ATOL = 1e-6


def _rotations(rng, n=16):
    phi = rng.normal(size=(n, 3)) * 0.8
    phi[0] = 0.0
    phi[1] = [np.pi - 1e-3, 0.0, 0.0]
    return np.asarray(jso3.exp(jnp.asarray(phi, jnp.float32)))


def _transforms(rng, n=16):
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    return np.asarray(jse3.exp(jnp.asarray(xi)))


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_se3_hat(rng):
    xi = rng.normal(size=(5, 3, 6)).astype(np.float32)
    _close(tse3.hat(torch.tensor(xi)), jse3.hat(jnp.asarray(xi)))


@pytest.mark.parametrize("batch_shape", [(), (3,), (2, 4)])
def test_se3_identity(batch_shape):
    got = tse3.identity(batch_shape=batch_shape)
    want = jse3.identity(batch_shape=batch_shape)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, 0.0)


def test_se3_transform_points(rng):
    t = _transforms(rng, 4)
    pts = rng.normal(size=(4, 50, 3)).astype(np.float32) * 3.0
    _close(tse3.transform_points(torch.tensor(t), torch.tensor(pts)),
           jse3.transform_points(jnp.asarray(t), jnp.asarray(pts)), 2e-6)


def test_se3_adjoint(rng):
    t = _transforms(rng)
    got = tse3.adjoint(torch.tensor(t))
    _close(got, jse3.adjoint(jnp.asarray(t)))
    # exp(Ad_T xi) = T exp(xi) T^-1
    xi = torch.tensor(rng.normal(size=(16, 6)).astype(np.float32)) * 0.1
    lhs = tse3.exp(torch.einsum("nij,nj->ni", got, xi))
    rhs = torch.tensor(t) @ tse3.exp(xi) @ tse3.inverse(torch.tensor(t))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-4)


def test_so3_vee(rng):
    m = rng.normal(size=(8, 3, 3)).astype(np.float32)
    _close(tso3.vee(torch.tensor(m)), jso3.vee(jnp.asarray(m)), 0.0)
    phi = torch.tensor(rng.normal(size=(8, 3)).astype(np.float32))
    assert torch.equal(tso3.vee(tso3.hat(phi)), phi)


def test_so3_theta(rng):
    r = _rotations(rng)
    _close(tso3.theta(torch.tensor(r)), jso3.theta(jnp.asarray(r)), 2e-6)


def test_so3_is_rotation_matrix(rng):
    r = _rotations(rng)
    bad = r.copy()
    bad[:4] *= 1.01  # not orthogonal
    bad[4:8, :, 0] *= -1.0  # reflections: det -1
    mats = np.concatenate([r, bad])
    got = tso3.is_rotation_matrix(torch.tensor(mats))
    want = np.asarray(jso3.is_rotation_matrix(jnp.asarray(mats)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:16].all() and not want[16:24].any()


def test_so3_wrap_angle(rng):
    a = np.concatenate([rng.uniform(-20.0, 20.0, size=64),
                        [-np.pi, np.pi, 0.0, 3 * np.pi, -3 * np.pi]]).astype(np.float32)
    _close(tso3.wrap_angle(torch.tensor(a)), jso3.wrap_angle(jnp.asarray(a)), 2e-6)


@pytest.mark.parametrize("event_ndim", [0, 2])
def test_t_distribution_weights(rng, event_ndim):
    res = (rng.normal(size=(3, 24, 32)) * 6.0).astype(np.float32)
    valid = rng.uniform(size=res.shape) > 0.2
    got = tweighting.t_distribution_weights(torch.tensor(res * res), torch.tensor(valid),
                                            TWeighter(), event_ndim=event_ndim)
    want = jweighting.t_distribution_weights(jnp.asarray(res * res), jnp.asarray(valid),
                                             JWeighter(), event_ndim=event_ndim)
    _close(got, want)


def test_weighted_error(rng):
    r2 = (rng.normal(size=(40, 30)) ** 2).astype(np.float32)
    w = rng.uniform(size=r2.shape).astype(np.float32)
    valid = rng.uniform(size=r2.shape) > 0.3
    err, count = tweighting.weighted_error(torch.tensor(r2), torch.tensor(w),
                                           torch.tensor(valid))
    want_err, want_count = jweighting.weighted_error(jnp.asarray(r2), jnp.asarray(w),
                                                     jnp.asarray(valid))
    np.testing.assert_allclose(float(err), float(want_err), rtol=1e-6)
    assert float(count) == float(want_count)


def test_make_tracker_matches_jax():
    """Two pairs of a 60x80 scene under the JAX dry run's small config
    (``__graft_entry__.entry``), the JAX package's pyramids handed over."""
    h, w = 60, 80
    gray, depth, k = synthetic.textured_scene(h, w, seed=0)
    poses = synthetic.handheld_trajectory(3, seed=0)
    grays, depths = synthetic.render_sequence(gray, depth, k, poses)
    for d in depths:
        d[:8], d[-8:], d[:, :8], d[:, -8:] = 0, 0, 0, 0
    kw = dict(levels=3, max_iterations=20, use_weighter=True)
    jcam = JCamera.create(k, 1.0)
    prep = jax.jit(lambda g, d: jrobust.preprocess_frame(g, d, jcam, levels=3))
    frames = [jax.tree.map(np.asarray, prep(g, d)) for g, d in zip(grays, depths)]
    prev = jax.tree.map(lambda *x: np.stack(x), frames[0], frames[1])
    curr = jax.tree.map(lambda *x: np.stack(x), frames[1], frames[2])
    want = jrobust.make_tracker(JConfig(**kw))(
        jax.tree.map(jnp.asarray, prev), jax.tree.map(jnp.asarray, curr), jnp.asarray(k))
    run = trobust.make_tracker(TConfig(**kw), device="cpu")
    got = run(trobust.frame_data_from_numpy(prev, "cpu"),
              trobust.frame_data_from_numpy(curr, "cpu"), k)
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want.transform), atol=1e-5)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_array_equal(got.diagnostics.iterations.numpy(),
                                  np.asarray(want.diagnostics.iterations))
    assert got.transform.device.type == "cpu"
