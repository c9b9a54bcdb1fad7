"""The port's Lie algebra, configuration and camera against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU.  Lie maps agree to 1e-6 (both are f32 with the same
series thresholds, so only rounding differs).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel as TCamera
from dense_visual_odometry_torch.config import RobustDVOConfig as TConfig
from dense_visual_odometry_torch.utils.lie import Pose as TPose
from dense_visual_odometry_torch.utils.lie import se3 as tse3
from dense_visual_odometry_torch.utils.lie import so3 as tso3
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.config import RobustDVOConfig as JConfig
from dense_visual_odometry_tpu.utils.lie import Pose as JPose
from dense_visual_odometry_tpu.utils.lie import se3 as jse3
from dense_visual_odometry_tpu.utils.lie import so3 as jso3

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.json"))
ATOL = 1e-6


def _twists(kind: str) -> np.ndarray:
    """Seeded (16, 6) twists: generic, near theta = 0, or near theta = pi."""
    rng = np.random.default_rng({"generic": 0, "small": 1, "near_pi": 2}[kind])
    xi = rng.normal(size=(16, 6))
    axis = xi[:, 3:] / np.linalg.norm(xi[:, 3:], axis=1, keepdims=True)
    if kind == "small":
        xi[:, 3:] = axis * rng.uniform(0.0, 1e-3, size=(16, 1))
    elif kind == "near_pi":
        xi[:, 3:] = axis * (np.pi - rng.uniform(1e-3, 2e-2, size=(16, 1)))
    else:
        xi[:, 3:] = axis * rng.uniform(0.05, 2.5, size=(16, 1))
    xi[:, :3] *= 0.3
    return xi.astype(np.float32)


def _j(f, *args):
    return np.asarray(jax.jit(f)(*[jnp.asarray(a) for a in args]))


def _t(f, *args):
    return f(*[torch.tensor(np.asarray(a)) for a in args]).numpy()


KINDS = ["generic", "small", "near_pi"]


@pytest.mark.parametrize("kind", KINDS)
def test_so3_exp_log_hat(kind):
    phi = _twists(kind)[:, 3:]
    np.testing.assert_allclose(_t(tso3.hat, phi), _j(jso3.hat, phi), atol=ATOL)
    rot = _j(jso3.exp, phi)
    np.testing.assert_allclose(_t(tso3.exp, phi), rot, atol=ATOL)
    np.testing.assert_allclose(_t(tso3.to_quat, rot), _j(jso3.to_quat, rot), atol=ATOL)
    # Near pi the axis sign of log is ill-conditioned in f32 in both
    # packages alike; compare what the rotation fixes: exp(log(R)).
    np.testing.assert_allclose(
        _t(lambda r: tso3.exp(tso3.log(r)), rot), rot, atol=1e-5
    )
    if kind != "near_pi":
        np.testing.assert_allclose(_t(tso3.log, rot), _j(jso3.log, rot), atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_se3_exp_log_inverse_compose(kind):
    xi = _twists(kind)
    m = _j(jse3.exp, xi)
    np.testing.assert_allclose(_t(tse3.exp, xi), m, atol=ATOL)
    np.testing.assert_allclose(_t(tse3.inverse, m), _j(jse3.inverse, m), atol=ATOL)
    m2 = np.roll(m, 1, axis=0)
    np.testing.assert_allclose(
        _t(tse3.compose, m, m2), _j(jse3.compose, m, m2), atol=ATOL
    )
    np.testing.assert_allclose(
        _t(tse3.left_jacobian, xi[:, 3:]), _j(jse3.left_jacobian, xi[:, 3:]), atol=ATOL
    )
    if kind != "near_pi":
        np.testing.assert_allclose(_t(tse3.log, m), _j(jse3.log, m), atol=1e-5)
        np.testing.assert_allclose(
            _t(tse3.left_jacobian_inverse, xi[:, 3:]),
            _j(jse3.left_jacobian_inverse, xi[:, 3:]), atol=ATOL,
        )


def test_pose_tum_round_trip():
    xi = _twists("generic")[3]
    tp = TPose.from_xi(xi)
    jp = JPose.from_xi(xi)
    np.testing.assert_allclose(tp.matrix.numpy(), np.asarray(jp.matrix), atol=ATOL)
    np.testing.assert_allclose(tp.to_tum(), jp.to_tum(), atol=ATOL)
    back = TPose.from_tum(*tp.to_tum())
    assert back.allclose(tp, atol=1e-5)
    np.testing.assert_allclose(
        (tp * tp.inverse()).matrix.numpy(), np.eye(4), atol=1e-6
    )


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_configs_load_to_equal_fields(path):
    assert _fields(TConfig.from_json(path)) == _fields(JConfig.from_json(path))


def test_config_field_sets_match():
    t = {f.name: f.default for f in dataclasses.fields(TConfig)}
    j = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert t.keys() == j.keys()
    t.pop("weighter"), j.pop("weighter")
    assert t == j


@pytest.mark.parametrize(
    "bad",
    [
        {"levels": 0},
        {"max_iterations": 0},
        {"levels": 2, "max_iterations_per_level": [3]},
        {"sigma": -1.0},
        {"lm_lambda0": 0.0},
        {"lm_up": 1.0},
        {"illumination": "gain"},
        {"recenter_blocks": 2},
        {"recenter_center_bound": 8},
        {"shift_stack_radius_y": 2},
        {"init_scale_ladder": [0.5]},
        {"use_esm_gradients": True},
        {"grid_strides": [1, 2]},
        {"weighter": {"scale_subsample": 0}},
        {"no_such_key": 1},
    ],
    ids=lambda d: next(iter(d)),
)
def test_config_validation_matches(bad):
    with pytest.raises(ValueError):
        JConfig.from_dict(bad)
    with pytest.raises(ValueError):
        TConfig.from_dict(bad)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_camera_levels(level):
    k = np.array([[517.3, 0.0, 318.6], [0.0, 516.5, 255.3], [0.0, 0.0, 1.0]], np.float32)
    np.testing.assert_allclose(
        TCamera.create(k, 2e-4).at(level).numpy(),
        np.asarray(JCamera.create(k, 2e-4).at(level)),
        rtol=1e-7,
    )


def test_camera_yaml(tmp_path):
    path = tmp_path / "camera.yaml"
    path.write_text(
        "intrinsics: [[517.3, 0.0, 318.6], [0.0, 516.5, 255.3], [0.0, 0.0, 1.0]]\n"
        "depth_scale: 0.0002\n"
        "distorssion_model: plumb_bob\n"
        "distorssion_coefficients: [0.26, -0.95, 0.0, 0.0, 1.16]\n"
    )
    t = TCamera.from_yaml(path)
    j = JCamera.from_yaml(path)
    np.testing.assert_array_equal(t.intrinsics.numpy(), np.asarray(j.intrinsics))
    assert t.depth_scale == j.depth_scale
    with pytest.raises(FileNotFoundError):
        TCamera.from_yaml(tmp_path / "missing.yaml")
