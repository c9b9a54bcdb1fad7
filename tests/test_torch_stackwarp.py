"""The stack warp and the "shift" evaluation of the port against the JAX package.

Both sides get the same numpy arrays: a seeded synthetic scene seen from a
second pose, at B=2 on a 30x40 grid, for grid strides 1 and 2.  The JAX
package's Pallas stack kernel runs in interpret mode, as its own tests run
it on the CPU; the port's wrappers take their plain versions because the
tensors lie on the CPU.

- ``shift_stack_sample_cuda`` and ``stack_accumulate`` against the XLA
  full sweep ``shift_stack_sample`` and the Pallas
  ``shift_stack_sample_pallas`` / ``stack_accumulate_pallas``;
- ``warp_residuals_shift`` against either JAX sampler, with a precomputed
  and with an exact (packed-gradient) Jacobian;
- the "shift" evaluation's Jacobian on the strided grid against JAX's
  full-resolution ``approximate_jacobian``, strided, with and without ESM;
- ``_affine_schur`` and ``_erode3`` of the solver.

Tolerance: 1e-5 relative on values and Jacobians, masks identical.  The
full sweep and the parity-plane sweep add the same non-zero taps in
different orders at stride 2, so their last bits may differ.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.io import synthetic
from dense_visual_odometry_torch.models import robust as trobust
from dense_visual_odometry_torch.ops import gradients as tgrad
from dense_visual_odometry_torch.ops import interp as tinterp
from dense_visual_odometry_torch.ops import residuals as tres
from dense_visual_odometry_torch.ops import shiftwarp as tshift
from dense_visual_odometry_torch.ops.cuda import stackwarp as tstack
from dense_visual_odometry_torch.utils.lie import se3
from dense_visual_odometry_tpu.models import robust as jrobust
from dense_visual_odometry_tpu.ops import interp as jinterp
from dense_visual_odometry_tpu.ops import residuals as jres
from dense_visual_odometry_tpu.ops import shiftwarp as jshift
from dense_visual_odometry_tpu.ops.pallas import stackwarp as jstack

GRID_H, GRID_W, RADIUS = 30, 40, 3
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
RTOL = 1e-5


def _np(x):
    return np.asarray(x)


def _jx(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module", params=[1, 2], ids=["s1", "s2"])
def case(request):
    """Images (B, H, W), the strided template and the warp (u, v) of its
    grid at a seeded pose near the truth."""
    s = request.param
    h, w = GRID_H * s, GRID_W * s
    gray, depth, k = synthetic.textured_scene(h, w, seed=7)
    poses = synthetic.handheld_trajectory(2, seed=8, t_step=0.02, r_step=0.01)
    grays, depths = synthetic.render_sequence(gray, depth, k, poses)
    pairs = [(0, 1), (1, 0)]
    gray_prev = torch.tensor(np.stack([grays[i] for i, _ in pairs]), dtype=torch.float32)
    depth_prev = torch.tensor(np.stack([depths[i] for i, _ in pairs]), dtype=torch.float32)
    gray_curr = torch.tensor(np.stack([grays[j] for _, j in pairs]), dtype=torch.float32)
    gt = np.stack([np.linalg.inv(poses[j]) @ poses[i] for i, j in pairs])
    xi = np.random.default_rng(s).normal(0, 3e-3, (2, 6))
    transform = se3.exp(torch.tensor(xi, dtype=torch.float32)) @ torch.tensor(gt, dtype=torch.float32)
    kt = torch.tensor(k, dtype=torch.float32)
    _, u, v, vg = tres.warp_geometry(depth_prev[:, ::s, ::s], kt, transform, s)
    return dict(s=s, k=kt, gray_prev=gray_prev, depth_prev=depth_prev,
                gray_curr=gray_curr, transform=transform, u=u, v=v, vg=vg)


def _assert_close(actual, expected):
    expected = _np(expected)
    np.testing.assert_allclose(
        _np(actual), expected, rtol=RTOL, atol=RTOL * max(np.abs(expected).max(), 1.0)
    )


def test_shift_stack_sample_matches_jax(case):
    s, img, u, v, vg = case["s"], case["gray_curr"], case["u"], case["v"], case["vg"]
    args = (img, u, v, RADIUS, s, vg)
    kern, ok_kern = tstack.shift_stack_sample_cuda(*args)
    jargs = (_jx(img), _jx(u), _jx(v))
    jkw = dict(radius=RADIUS, grid_stride=s, coord_mask=_jx(vg))
    j_full, j_ok_full = jshift.shift_stack_sample(*jargs, **jkw)
    j_pl, j_ok_pl = jstack.shift_stack_sample_pallas(*jargs, **jkw, interpret=True)
    valid = _np(ok_kern)
    assert 0 < valid.sum() < valid.size
    for ok in (j_ok_full, j_ok_pl):
        np.testing.assert_array_equal(_np(ok), valid)
    _assert_close(kern, j_pl)
    _assert_close(kern, j_full)


def test_stack_accumulate_matches_pallas(case):
    s = case["s"]
    planes, du, dv, valid = tshift.prepare_shift_stack(
        case["gray_curr"], case["u"], case["v"], RADIUS, s, case["vg"]
    )
    j_planes, j_du, j_dv, j_valid = jstack.prepare_shift_stack(
        _jx(case["gray_curr"]), _jx(case["u"]), _jx(case["v"]), radius=RADIUS,
        grid_stride=s, coord_mask=_jx(case["vg"]),
    )
    np.testing.assert_array_equal(planes.numpy(), _np(j_planes))
    np.testing.assert_array_equal(du.numpy(), _np(j_du))
    np.testing.assert_array_equal(valid.numpy(), _np(j_valid))
    before = tstack.stack_accumulate.launches
    acc = tstack.stack_accumulate(planes, du.contiguous(), dv.contiguous(), RADIUS, s)
    assert tstack.stack_accumulate.launches == before  # CPU tensors: the plain version
    j_acc = jstack.stack_accumulate_pallas(j_planes, j_du, j_dv, RADIUS, grid_stride=s,
                                           interpret=True)
    m = valid.numpy()
    _assert_close(acc.numpy()[m], _np(j_acc)[m])


@pytest.mark.parametrize("jax_pallas", [True, False], ids=["kernel", "full_sweep"])
@pytest.mark.parametrize("jacobian", ["precomputed", "exact"])
def test_warp_residuals_shift_matches_jax(case, jacobian, jax_pallas):
    s, k = case["s"], case["k"]
    gp, dp, gc = case["gray_prev"], case["depth_prev"], case["gray_curr"]
    gx1, gy1 = tgrad.sobel(gp)
    t_jac = j_jac = t_grads = j_grads = None
    if jacobian == "precomputed":
        t_jac = tres.approximate_jacobian_planes(
            dp[:, ::s, ::s], k, (gx1 / 8.0)[:, ::s, ::s], (gy1 / 8.0)[:, ::s, ::s], s
        ).permute(0, 2, 3, 1)
        j_jac = jres.approximate_jacobian(
            _jx(gp), _jx(dp), _jx(k), _jx(gx1 / 8.0), _jx(gy1 / 8.0)
        )[:, ::s, ::s, :]
    else:
        gx2, gy2 = tgrad.sobel(gc)
        t_grads = tinterp.pack_pair_f16(gx2 / 8.0, gy2 / 8.0)
        j_grads = jinterp.pack_pair_f16(_jx(gx2 / 8.0), _jx(gy2 / 8.0))
        np.testing.assert_array_equal(t_grads.numpy(), _np(j_grads))
    gp_s, dp_s = gp[:, ::s, ::s], dp[:, ::s, ::s]
    t = tres.warp_residuals_shift(
        gp_s, dp_s, gc, k, case["transform"], grads_packed=t_grads,
        precomputed_jacobian=t_jac, grid_stride=s, radius=RADIUS,
    )
    j = jres.warp_residuals_shift(
        _jx(gp_s), _jx(dp_s), _jx(gc), _jx(k), _jx(case["transform"]),
        grads_packed=j_grads, precomputed_jacobian=j_jac, grid_stride=s,
        radius=RADIUS, use_pallas=jax_pallas,
    )
    res, jac, valid = (x.numpy() for x in t)
    np.testing.assert_array_equal(valid, _np(j[2]))
    assert 0 < valid.sum() < valid.size
    _assert_close(res, j[0])
    _assert_close(jac, j[1])


@pytest.mark.parametrize("esm", [False, True], ids=["no_esm", "esm"])
def test_shift_jacobian_matches_jax(case, esm):
    """Affine's "shift" Hessian takes the template's own Jacobian on the
    strided grid, also at an ESM level, whose planes hold ESM's average."""
    s, k, gp, dp = case["s"], case["k"], case["gray_prev"], case["depth_prev"]
    data = json.loads((CONFIGS / "tpu_parity.json").read_text())
    cfg = RobustDVOConfig.from_dict({
        **data, "illumination": "affine", "use_esm_gradients": esm,
        "esm_levels": [0], "grid_strides": [s, 2, 1, 1],
    })
    fl = trobust.prepare_level(gp, dp, case["gray_curr"], k, case["transform"], cfg, 0)
    g1x_s, g1y_s = trobust._template_gradients(
        gp, dp, case["gray_curr"], k, case["transform"], cfg, 0
    )
    jac = tres.approximate_jacobian(fl.depth_prev_m, k, g1x_s, g1y_s, s)
    sgain = trobust._SOBEL_GAIN
    gx1, gy1 = tgrad.sobel(gp)
    j_jac = jres.approximate_jacobian(
        _jx(gp), _jx(dp), _jx(k), _jx(gx1 / sgain), _jx(gy1 / sgain)
    )[:, ::s, ::s, :]
    _assert_close(jac, j_jac)
    assert torch.equal(fl.pre_jac, jac)  # the level's "shift" evaluations take it
    # At the ESM level the level's own planes differ from it.
    differs = not torch.equal(jac, fl.jac_planes.permute(0, 2, 3, 1))
    assert differs == esm


def test_affine_schur_matches_jax():
    rng = np.random.default_rng(11)
    b, h, w = 2, 12, 16
    jac = rng.normal(0, 50, (b, h, w, 6)).astype(np.float32)
    res = rng.normal(0, 5, (b, h, w)).astype(np.float32)
    wts = rng.uniform(0, 1, (b, h, w)).astype(np.float32)
    tpl = rng.normal(0, 30, (b, h, w)).astype(np.float32)
    t_sys = tres.normal_equations(*(torch.tensor(x) for x in (res, jac, wts)), torch.tensor(wts > 0))
    j_sys = jres.normal_equations(*(jnp.asarray(x) for x in (res, jac, wts, wts > 0)))
    t_out = trobust._affine_schur(t_sys, *(torch.tensor(x) for x in (res, jac, wts, tpl)))
    j_out = jrobust._affine_schur(j_sys, *(jnp.asarray(x) for x in (res, jac, wts, tpl)))
    for name in ("hessian", "rhs", "error", "count"):
        expected = _np(getattr(j_out, name))
        np.testing.assert_allclose(
            getattr(t_out, name).numpy(), expected, rtol=1e-4,
            atol=1e-4 * np.abs(expected).max(),
        )
    # The elimination really changed the system.
    assert np.abs(_np(j_out.hessian) - _np(j_sys.hessian)).max() > 1e-3 * np.abs(_np(j_sys.hessian)).max()


def test_erode3_matches_jax():
    mask = np.random.default_rng(12).uniform(size=(3, 17, 23)) > 0.15
    out = trobust._erode3(torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(out, _np(jrobust._erode3(jnp.asarray(mask))))
    assert 0 < out.sum() < mask.sum()


def test_stack_accumulate_checks_inputs():
    b, hp, wp, r = 1, 4, 5, 3
    planes = torch.zeros(b, 1, 2 * r + hp, 2 * r + wp)
    d = torch.zeros(b, hp, wp)
    with pytest.raises(ValueError, match="shape"):
        tstack.stack_accumulate(planes[:, :, 1:], d, d, r, 1)
    with pytest.raises(TypeError, match="float32"):
        tstack.stack_accumulate(planes, d.double(), d, r, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tstack.stack_accumulate(planes, d, torch.zeros(b, wp, hp).transpose(1, 2), r, 1)
    # Every stride >= 1 is taken (stride 3: 9 parity planes of 2r // 3 more
    # rows and columns); stride 0 is refused.
    with pytest.raises(ValueError, match="grid_stride must be >= 1"):
        tstack.stack_accumulate(planes, d, d, r, 0)
    out = tstack.stack_accumulate(torch.zeros(b, 9, 2 * r // 3 + hp, 2 * r // 3 + wp), d, d, r, 3)
    assert out.shape == (b, hp, wp)
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tstack.stack_accumulate(planes.to(meta), d.to(meta), d.to(meta), r, 1)
