"""The port's plain sampling, residuals and precomputed Jacobian against the
JAX package.

Seeded numpy inputs go to both packages; the port runs on the CPU.  As in
``test_torch_image_ops.py``, float results agree to 1e-6 relative (1e-5
where a difference of products cancels, the Jacobians), with an absolute
floor where a value can cross zero, and masks are identical: warps are
taken at generic poses, so no sample lands on a bounds edge, where the last
bit decides its validity.

- ``bilinear_sample`` (four float32 taps, the reference's lerp order);
- ``warp_residuals`` in exact mode (the current image's gradients sampled
  bilinearly, the warp Jacobian at the transformed points) and with a
  precomputed Jacobian, at strides 1 and 2;
- the precomputed Jacobian: the JAX package builds it at full resolution
  and strides it, the port on the strided grid; at stride 2 the values are
  equal, with and without ESM's average (the current image's gradients
  sampled nearest at the level-start warp of the full-resolution grid);
- the warp of a strided template pixel: the stride-2 grid forms the same
  floats as the stride-1 grid at the same pixel, so the ESM sample taken on
  the full-resolution grid is the one the strided grid would take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.config import RobustDVOConfig as TConfig
from dense_visual_odometry_torch.models import robust as trobust
from dense_visual_odometry_torch.ops import interp as tinterp
from dense_visual_odometry_torch.ops import residuals as tres
from dense_visual_odometry_tpu.models import robust as jrobust
from dense_visual_odometry_tpu.ops import gradients as jgrad
from dense_visual_odometry_tpu.ops import interp as jinterp
from dense_visual_odometry_tpu.ops import residuals as jres

RTOL = 1e-6
B, H, W = 2, 24, 32
SGAIN = 8.0


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, rtol=RTOL, atol=0.0):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def data():
    """Seeded smooth images, metric depth, intrinsics and two generic poses."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    gray = np.stack([
        120 + 60 * np.sin(xx / (3.0 + b) + 0.4 * b) * np.cos(yy / 4.0) for b in range(B)
    ]).astype(np.float32)
    gray2 = np.clip(gray + rng.normal(0, 4, (B, H, W)), 0, 255).astype(np.float32)
    depth = rng.uniform(1.0, 2.5, (B, H, W)).astype(np.float32)
    depth[:, 5:8, 6:11] = 0.0  # invalid depth
    k = np.array([[30.0, 0.0, 15.3], [0.0, 29.0, 11.7], [0.0, 0.0, 1.0]], np.float32)
    xi = np.array(
        [[0.013, -0.007, 0.02, 0.011, -0.006, 0.004],
         [-0.009, 0.012, -0.015, -0.004, 0.008, -0.007]], np.float32
    )
    pose = np.asarray(jax.jit(jrobust.se3.exp)(jnp.asarray(xi)))
    return dict(gray=gray, gray2=gray2, depth=depth, k=k, pose=pose, rng=rng)


def test_bilinear_sample_matches_jax(data):
    rng = np.random.default_rng(5)
    u = rng.uniform(-2.0, W + 1.0, (B, 9, 11)).astype(np.float32)
    v = rng.uniform(-2.0, H + 1.0, (B, 9, 11)).astype(np.float32)
    u[0, 0, :3] = [0.0, W - 2.0, W - 1.0]  # on the bounds edges
    v[0, 0, :3] = [0.0, H - 2.0, H - 1.0]
    u[1, 0, 0] = np.nan
    t_val, t_ok = tinterp.bilinear_sample(_t(data["gray"]), _t(u), _t(v))
    j_val, j_ok = jax.jit(jinterp.bilinear_sample)(data["gray"], u, v)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert 0 < int(t_ok.sum()) < t_ok.numel()
    _close(t_val, j_val)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "precomputed"])
def test_warp_residuals_matches_jax(data, stride, exact):
    s = stride
    gp = data["gray"][:, ::s, ::s]
    dp = data["depth"][:, ::s, ::s]
    gc, k, pose = data["gray2"], data["k"], data["pose"]
    gx, gy = (np.asarray(g) / SGAIN for g in jax.jit(jgrad.sobel)(gc))
    if exact:
        jargs = dict(grad_x_curr=gx, grad_y_curr=gy)
        targs = dict(grad_x_curr=_t(gx), grad_y_curr=_t(gy))
    else:
        gx1, gy1 = (np.asarray(g) / SGAIN for g in jax.jit(jgrad.sobel)(data["gray"]))
        pre = np.asarray(jax.jit(jres.approximate_jacobian)(
            data["gray"], data["depth"], k, gx1, gy1))[:, ::s, ::s]
        jargs = dict(precomputed_jacobian=pre)
        targs = dict(precomputed_jacobian=_t(pre))
    j = jax.jit(lambda *a: jres.warp_residuals(*a, **jargs, grid_stride=s))(gp, dp, gc, k, pose)
    t = tres.warp_residuals(_t(gp), _t(dp), _t(gc), _t(k), _t(pose), **targs, grid_stride=s)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert 0 < int(t[2].sum()) < t[2].numel()
    _close(t[0], j[0], atol=1e-4)
    _close(t[1], j[1], rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(j[1])).max()))


@pytest.mark.parametrize("esm", [False, True], ids=["template", "esm"])
def test_strided_jacobian_equals_full_resolution_strided(data, esm):
    """The port's precomputed Jacobian on the stride-2 grid against the JAX
    package's full-resolution one, strided (``robust.py:464-488, 505-506``)."""
    s = 2
    gp, dp, gc, k, pose = data["gray"], data["depth"], data["gray2"], data["k"], data["pose"]
    cfg = TConfig(levels=2, grid_strides=(s, 1), approximate_image2_gradient=True,
                  use_esm_gradients=esm)
    g1x_s, g1y_s = trobust._template_gradients(
        _t(gp), _t(dp), _t(gc), _t(k), _t(pose), cfg, 0, esm=esm
    )
    t_jac = tres.approximate_jacobian(_t(dp[:, ::s, ::s]), _t(k), g1x_s, g1y_s, s)

    def jax_jacobian(gp, dp, gc, k, pose):
        gx1, gy1 = jgrad.sobel(gp)
        g1x, g1y = gx1 / SGAIN, gy1 / SGAIN
        if esm:
            gx2, gy2 = jgrad.sobel(gc)
            packed = jinterp.pack_pair_f16(gx2 / SGAIN, gy2 / SGAIN)
            _, u0, v0, vg0 = jres._warp_geometry(dp, k, pose, 1)
            g2x, g2y, ok2 = jinterp.nearest_sample_packed(packed, u0, v0)
            okm = vg0 & ok2
            g1x = jnp.where(okm, 0.5 * (g1x + g2x), g1x)
            g1y = jnp.where(okm, 0.5 * (g1y + g2y), g1y)
        return jres.approximate_jacobian(gp, dp, k, g1x, g1y)[:, ::s, ::s, :]

    j_jac = np.asarray(jax.jit(jax_jacobian)(gp, dp, gc, k, pose))
    _close(t_jac, j_jac, rtol=1e-5, atol=1e-5 * float(np.abs(j_jac).max()))
    # Built by the port at full resolution and strided, the values are equal.
    full = tres.approximate_jacobian(
        _t(dp), _t(k), *trobust._template_gradients(
            _t(gp), _t(dp), _t(gc), _t(k), _t(pose),
            TConfig(levels=2, approximate_image2_gradient=True), 0, esm=esm,
        ),
    )[:, ::s, ::s, :]
    np.testing.assert_array_equal(t_jac.numpy(), full.numpy())


def test_strided_warp_equals_full_resolution_warp(data):
    """At a strided pixel the stride-2 warp forms the same floats as the
    stride-1 warp (``deproject_grid``'s grid coordinates are exact)."""
    dp, k, pose = _t(data["depth"]), _t(data["k"]), _t(data["pose"])
    full = tres.warp_geometry(dp, k, pose, 1)
    strided = tres.warp_geometry(dp[:, ::2, ::2], k, pose, 2)
    for a, b in zip(full, strided):
        np.testing.assert_array_equal(a[:, ::2, ::2].numpy(), b.numpy())
