"""The port's image, sampling, residual and weighting ops against the JAX package.

Every input is made with numpy from a seed and handed to both packages; the
port runs on the CPU.  Integer-valued and selection results (medians, f16
packing, masks, window extraction) must be bit-identical; float results
agree to 1e-6 relative, with an absolute floor where a value can cross
zero, and to 1e-5 where a difference of products cancels (the Jacobian
planes) or a whole image is summed.  The JAX side is jitted, and XLA:CPU
contracts multiply-adds into fused multiply-adds where PyTorch rounds each
product, so float results differ in the last bits; warps are taken at
generic poses so that no sample lands exactly on a bounds or ball edge,
where the last bit decides its validity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.config import TWeighterConfig as TWCfg
from dense_visual_odometry_torch.models import robust as trobust
from dense_visual_odometry_torch.models import weighting as tweighting
from dense_visual_odometry_torch.ops import gradients as tgrad
from dense_visual_odometry_torch.ops import interp as tinterp
from dense_visual_odometry_torch.ops import pyramid as tpyr
from dense_visual_odometry_torch.ops import residuals as tres
from dense_visual_odometry_torch.ops import shiftwarp as tshift
from dense_visual_odometry_torch.utils.lie import se3 as tse3
from dense_visual_odometry_tpu.config import TWeighterConfig as JWCfg
from dense_visual_odometry_tpu.models import robust as jrobust
from dense_visual_odometry_tpu.models import weighting as jweighting
from dense_visual_odometry_tpu.ops import gradients as jgrad
from dense_visual_odometry_tpu.ops import interp as jinterp
from dense_visual_odometry_tpu.ops import pyramid as jpyr
from dense_visual_odometry_tpu.ops import residuals as jres
from dense_visual_odometry_tpu.ops import shiftwarp as jshift
from dense_visual_odometry_tpu.ops.pallas import stackwarp as jstack

RTOL = 1e-6
B, H, W = 2, 24, 32


def _t(x):
    return torch.tensor(np.asarray(x))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(_n(a), _n(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def data():
    """Seeded images, metric depth, intrinsics and two generic poses."""
    rng = np.random.default_rng(7)
    gray = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    gray2 = np.clip(gray + rng.normal(0, 8, (B, H, W)), 0, 255).astype(np.float32)
    depth = rng.uniform(0.8, 3.0, (B, H, W)).astype(np.float32)
    depth[:, 3:6, 4:9] = 0.0  # invalid depth
    k = np.array([[30.0, 0.0, 15.3], [0.0, 29.0, 11.7], [0.0, 0.0, 1.0]], np.float32)
    xi = np.array(
        [[0.013, -0.007, 0.02, 0.011, -0.006, 0.004],
         [-0.009, 0.012, -0.015, -0.004, 0.008, -0.007]], np.float32
    )
    pose = np.asarray(jax.jit(jrobust.se3.exp)(jnp.asarray(xi)))
    return dict(gray=gray, gray2=gray2, depth=depth, k=k, pose=pose, rng=rng)


def test_median_pyramid_bit_identical(data):
    j = jax.jit(lambda x: jpyr.build_pyramid(x, 4))(data["gray"])
    t = tpyr.build_pyramid(_t(data["gray"]), 4)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_n(a), _n(b))
    np.testing.assert_array_equal(
        _n(tpyr.median3x3(_t(data["depth"]))),
        _n(jax.jit(jpyr.median3x3)(data["depth"])),
    )


@pytest.mark.parametrize("shape,kind", [
    ((1, 1), "gray"), ((2, 3), "gray"), ((31, 45), "gray"), ((61, 81), "gray"),
    ((2, 3, 31, 45), "gray"), ((2, 61, 81), "nan_inf"), ((2, 61, 81), "depth"),
], ids=["1x1", "2x3", "31x45", "61x81", "lead2x3", "nan_inf", "depth_zeros"])
def test_median_pyramid_bit_identical_shapes(shape, kind):
    """The port's pyramid (the plain path of its kernel wrapper) at odd and
    tiny shapes, extra leading dims, NaN and +-inf pixels, and depth with
    zeroed pixels: equal to the JAX package's, NaN where NaN."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 255, shape).astype(np.float32)
    if kind == "nan_inf":
        x[..., 3, 5] = x[..., 18, 20] = np.nan
        x[..., 10, 11:13] = np.inf
        x[..., 17, 20] = -np.inf
        x[..., -2:, -2:] = np.inf
    if kind == "depth":
        x /= 64.0
        x[..., 3:9, 4:15] = 0.0
        x[rng.uniform(size=shape) < 0.1] = 0.0
    j = jax.jit(lambda v: jpyr.build_pyramid(v, 4))(x)
    t = tpyr.build_pyramid(_t(x), 4)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_n(a), _n(b))
    if kind == "nan_inf":
        assert np.isnan(_n(t[1])).any() and np.isinf(_n(t[1])).any()


@pytest.mark.parametrize("quantize", [False, True])
def test_rgb_to_gray(data, quantize):
    rgb = data["rng"].integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    j = jax.jit(lambda x: jpyr.rgb_to_gray(x, quantize=quantize))(rgb)
    t = tpyr.rgb_to_gray(_t(rgb), quantize=quantize)
    _close(t, j, atol=1e-4 if not quantize else 0.0)
    if quantize:
        np.testing.assert_array_equal(_n(t), _n(j))


def test_preprocess_depth(data):
    raw = data["rng"].integers(0, 40000, (B, H, W)).astype(np.uint16)
    j = jax.jit(lambda d: jpyr.preprocess_depth(d, 2e-4, 5.0))(raw)
    t = tpyr.preprocess_depth(_t(raw.astype(np.int64)), 2e-4, 5.0)
    _close(t, j)
    assert (_n(t) == 0).sum() == (_n(j) == 0).sum() > 0


def test_preprocess_frame(data):
    from dense_visual_odometry_torch.camera import CameraModel as TCam
    from dense_visual_odometry_tpu.camera import CameraModel as JCam

    rgb = data["rng"].integers(0, 256, (H, W, 3)).astype(np.uint8)
    raw = data["rng"].integers(0, 30000, (H, W)).astype(np.uint16)
    j = jax.jit(
        lambda c, d: jrobust.preprocess_frame(c, d, JCam.create(data["k"], 2e-4), levels=3)
    )(rgb, raw)
    t = trobust.preprocess_frame(rgb, raw, TCam.create(data["k"], 2e-4), levels=3, device="cpu")
    for a, b in zip(t.gray + t.depth_m, j.gray + j.depth_m):
        _close(a, b, atol=1e-4)


def test_sobel(data):
    jx, jy = jax.jit(jgrad.sobel)(data["gray"])
    tx, ty = tgrad.sobel(_t(data["gray"]))
    _close(tx, jx, atol=1e-3)
    _close(ty, jy, atol=1e-3)


def test_f16_packing_bit_identical(data):
    a = data["gray"] * 1.37
    b = -data["gray2"] / 3.0
    j = jax.jit(jinterp.pack_pair_f16)(a, b)
    t = tinterp.pack_pair_f16(_t(a), _t(b))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(_n(t), _n(j))
    ja, jb = jax.jit(jinterp.unpack_pair_f16)(j)
    ta, tb = tinterp.unpack_pair_f16(t)
    np.testing.assert_array_equal(_n(ta), _n(ja))
    np.testing.assert_array_equal(_n(tb), _n(jb))
    np.testing.assert_array_equal(
        _n(tinterp.pack_neighbors(_t(a))), _n(jax.jit(jinterp.pack_neighbors)(a))
    )


def _coords(data, spread):
    rng = np.random.default_rng(11)
    u = rng.uniform(-2.0, W + 1.0, (B, 10, 12)).astype(np.float32)
    v = rng.uniform(-2.0, H + 1.0, (B, 10, 12)).astype(np.float32)
    return u * spread, v * spread


def test_packed_bilinear_and_nearest(data):
    u, v = _coords(data, 1.0)
    packed = jax.jit(jinterp.pack_neighbors)(data["gray"])
    jv, jok = jax.jit(jinterp.bilinear_sample_packed)(packed, u, v)
    tv, tok = tinterp.bilinear_sample_packed(_t(packed), _t(u), _t(v))
    np.testing.assert_array_equal(_n(tok), _n(jok))
    assert 0 < _n(tok).sum() < tok.numel()
    _close(tv, jv, rtol=RTOL, atol=1e-4)

    gpack = jax.jit(jinterp.pack_pair_f16)(data["gray"], data["gray2"])
    ja, jb, jok = jax.jit(jinterp.nearest_sample_packed)(gpack, u, v)
    ta, tb, tok = tinterp.nearest_sample_packed(_t(gpack), _t(u), _t(v))
    np.testing.assert_array_equal(_n(tok), _n(jok))
    np.testing.assert_array_equal(_n(ta), _n(ja))
    np.testing.assert_array_equal(_n(tb), _n(jb))


@pytest.mark.parametrize("stride", [1, 2])
def test_warp_geometry_and_jacobian_planes(data, stride):
    d = data["depth"][..., ::stride, ::stride]
    jp, ju, jv, jok = jax.jit(
        lambda d, k, t: jres._warp_geometry(d, k, t, stride)
    )(d, data["k"], data["pose"])
    tp, tu, tv, tok = tres.warp_geometry(_t(d), _t(data["k"]), _t(data["pose"]), stride)
    np.testing.assert_array_equal(_n(tok), _n(jok))
    _close(tu, ju, rtol=1e-6, atol=1e-5)
    _close(tv, jv, rtol=1e-6, atol=1e-5)
    _close(tp, jp, rtol=1e-6, atol=1e-6)

    gx, gy = jax.jit(jgrad.sobel)(data["gray"])
    gxs, gys = np.asarray(gx)[..., ::stride, ::stride] / 8, np.asarray(gy)[..., ::stride, ::stride] / 8
    jj = jax.jit(lambda *a: jres.approximate_jacobian_planes(*a, grid_stride=stride))(
        d, data["k"], gxs, gys
    )
    tj = tres.approximate_jacobian_planes(_t(d), _t(data["k"]), _t(gxs), _t(gys), stride)
    assert tuple(tj.shape) == (B, 6) + d.shape[-2:]
    # j2..j5 are differences of products, contracted into FMAs by XLA.
    _close(tj, jj, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["precomputed", "exact"])
def test_warp_residuals_packed_and_normal_equations(data, mode):
    stride = 2
    gp = data["gray"][..., ::stride, ::stride]
    dp = data["depth"][..., ::stride, ::stride]
    packed = np.asarray(jax.jit(jinterp.pack_neighbors)(data["gray2"]))
    gx, gy = jax.jit(jgrad.sobel)(data["gray2"])
    gpack = np.asarray(jax.jit(jinterp.pack_pair_f16)(gx / 8, gy / 8))
    pre = np.moveaxis(
        np.asarray(data["rng"].normal(0, 30, (B, 6) + gp.shape[-2:])), 1, -1
    ).astype(np.float32)
    kw = (
        dict(precomputed_jacobian=pre) if mode == "precomputed" else dict(grads_packed=gpack)
    )
    j = jax.jit(
        lambda *a: jres.warp_residuals_packed(*a, grid_stride=stride, **kw)
    )(gp, dp, packed, data["k"], data["pose"])
    tkw = {key: _t(val) for key, val in kw.items()}
    t = tres.warp_residuals_packed(
        _t(gp), _t(dp), _t(packed), _t(data["k"]), _t(data["pose"]),
        grid_stride=stride, **tkw,
    )
    np.testing.assert_array_equal(_n(t[2]), _n(j[2]))
    _close(t[0], j[0], rtol=RTOL, atol=1e-3)
    _close(t[1], j[1], rtol=RTOL, atol=1e-3)

    wts = np.where(np.asarray(j[2]), data["rng"].uniform(0.2, 1.0, gp.shape), 0.0).astype(np.float32)
    js = jax.jit(jres.normal_equations)(j[0], j[1], wts, j[2])
    ts = tres.normal_equations(_t(j[0]), _t(j[1]), _t(wts), _t(j[2]))
    for a, b in zip(ts, js):
        _close(a, b, rtol=RTOL, atol=1e-2)
    jb = jax.jit(jrobust._bias_schur)(js, j[0], j[1], wts)
    tb = trobust._bias_schur(
        tres.ResidualSystem(*(_t(x) for x in js)), _t(j[0]), _t(j[1]), _t(wts)
    )
    for a, b in zip(tb, jb):
        _close(a, b, rtol=RTOL, atol=1e-2)


@pytest.mark.parametrize(
    "cfg",
    [
        dict(scale_subsample=4),
        dict(scale_subsample=1, unroll_iterations=3),
        dict(scale_subsample=2, normalize_scale=False),
    ],
    ids=["while_subsample4", "unrolled", "unnormalized"],
)
@pytest.mark.parametrize("warm", [False, True])
def test_t_distribution_weights(data, cfg, warm):
    res = data["rng"].normal(0, 6, (B, H, W)).astype(np.float32)
    valid = data["rng"].uniform(size=(B, H, W)) > 0.2
    lam0 = np.array([0.02, 0.05], np.float32) if warm else None
    jw, jl = jax.jit(
        lambda r, v, l0: jweighting.t_distribution_weights_with_scale(
            r * r, v, JWCfg(**cfg), event_ndim=2, init_lambda=l0
        )
    )(res, valid, lam0)
    tw, tl = tweighting.t_distribution_weights_with_scale(
        _t(res) ** 2, _t(valid), TWCfg(**cfg), event_ndim=2,
        init_lambda=None if lam0 is None else _t(lam0),
    )
    _close(tl, jl, rtol=RTOL)
    _close(tw, jw, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_recenter_coverage_and_displacements(data, stride):
    d = data["depth"][..., ::stride, ::stride]
    _, u, v, ok = jax.jit(lambda d, k, t: jres._warp_geometry(d, k, t, stride))(
        d, data["k"], data["pose"] * np.float32(1.0)
    )
    # A translation of a few pixels on top of the warp, so the recentring
    # has something to absorb.
    u = np.asarray(u) + np.float32(2.3)
    v = np.asarray(v) - np.float32(1.6)
    ok = np.asarray(ok)
    r = 3
    jcov = jax.jit(lambda *a: jshift.shift_coverage(a[0], a[1], r, stride, coord_mask=a[2]))(u, v, ok)
    tcov = tshift.shift_coverage(_t(u), _t(v), r, stride, coord_mask=_t(ok))
    _close(tcov, jcov)
    jcu, jcv = jax.jit(lambda *a: jstack.compute_recenter(a[0], a[1], r, stride, a[2]))(u, v, ok)
    tcu, tcv = tshift.compute_recenter(_t(u), _t(v), r, stride, _t(ok))
    np.testing.assert_array_equal(_n(tcu), _n(jcu))
    np.testing.assert_array_equal(_n(tcv), _n(jcv))
    jd = jax.jit(lambda *a: jstack.residual_displacements(*a, r, stride, H, W))(u, v, jcu, jcv)
    td = tshift.residual_displacements(_t(u), _t(v), tcu, tcv, r, stride, H, W)
    _close(td[0], jd[0], atol=1e-6)
    _close(td[1], jd[1], atol=1e-6)
    np.testing.assert_array_equal(_n(td[2]), _n(jd[2]))


@pytest.mark.parametrize("stride", [1, 2])
def test_parity_planes_and_tent_taps(data, stride):
    """Window extraction is bit-identical; tent taps read <= 4 taps of the
    window and equal the Pallas kernel's full tap sweep on in-ball pixels."""
    r = 3
    hp, wp = H // stride, W // stride
    cu = np.array([2, -5], np.int32)
    cv = np.array([-1, 4], np.int32)
    jpl = jax.jit(lambda i, a, b: jstack.extract_parity_planes(i, a, b, hp, wp, r, stride))(
        data["gray2"], cu, cv
    )
    tpl = tshift.extract_parity_planes(_t(data["gray2"]), _t(cu), _t(cv), hp, wp, r, stride)
    np.testing.assert_array_equal(_n(tpl), _n(jpl))
    du = data["rng"].uniform(-r + 1e-3, r - 1e-3, (B, hp, wp)).astype(np.float32)
    dv = data["rng"].uniform(-r + 1e-3, r - 1e-3, (B, hp, wp)).astype(np.float32)
    acc = jstack.stack_accumulate_pallas(jpl, du, dv, r, grid_stride=stride, interpret=True)
    tacc = tshift.tent_sample(tpl, _t(du), _t(dv), r, stride)
    _close(tacc, acc, rtol=1e-6, atol=1e-4)


def test_box2_and_initial_photometric_error(data):
    jb = jax.jit(jrobust._box2)(data["gray"])
    tb = trobust._box2(_t(data["gray"]))
    _close(tb, jb)
    packed = np.asarray(jax.jit(jinterp.pack_neighbors)(data["gray2"]))
    je = jax.jit(jrobust._initial_photometric_error)(
        data["gray"], data["depth"], packed, data["k"], data["pose"]
    )
    te = trobust._initial_photometric_error(
        _t(data["gray"]), _t(data["depth"]), _t(packed), _t(data["k"]), _t(data["pose"])
    )
    # A sum over the image of squared residuals.
    _close(te, je, rtol=1e-5)


def test_se3_rows_match_matrix_form(data):
    """The level solver's scalar-column algebra equals the matrix form."""
    from dense_visual_odometry_torch.ops.cuda import level_solver as tls

    xi = _t(np.array([[0.01, -0.02, 0.03, 0.2, -0.1, 0.05], [1e-4, 0, 0, 1e-5, 0, 0]], np.float32))
    rows = torch.stack(tls.se3_exp_rows(tuple(xi.T)), dim=1).reshape(2, 3, 4)
    _close(rows, tse3.exp(xi)[:, :3, :], atol=1e-6)
    m = tse3.exp(xi)[:, :3, :].reshape(2, 12)
    comp = torch.stack(tls.compose_rows(tuple(m.T), tuple(m.flip(0).T)), 1)
    _close(comp.reshape(2, 3, 4), (tse3.exp(xi) @ tse3.exp(xi.flip(0)))[:, :3], atol=1e-6)
    inv = torch.stack(tls.inverse_rows(tuple(m.T)), 1)
    _close(inv.reshape(2, 3, 4), tse3.inverse(tse3.exp(xi))[:, :3], atol=1e-6)
