"""The kernels' plain versions against the JAX package's Pallas kernels.

``lm_level_plain`` is held against ``lm_level_pallas`` and the fused
kernel's plain version (``fused_evaluation_plain``, the level kernel's
evaluation ``level_evaluation``) against ``fused_iteration_pallas`` and
``fused_shift_iteration``, the Pallas kernels run in interpret mode as the
JAX package's own tests run them on the CPU (the stack kernel's plain
version is held against its Pallas kernel in ``test_torch_stackwarp.py``).
Both sides get the same numpy arrays: a seeded synthetic scene seen from a
second pose, at B=2 on a 30x40 grid, for grid strides 1 and 2, without
illumination, with the bias and (level kernel) with affine gain + bias, and
with and without the relative tolerance.  The fused kernel warps the
template points itself; the Pallas kernel gets the displacements and
validity of the same pose.

Tolerances: transforms 1e-5 absolute; iteration counts identical; err,
count and the IRLS lambda 1e-4 relative.  The solves start from a generic
pose (the truth off by a seeded twist): under the identity warp a template
pixel on the image border projects exactly onto the bounds test's edge,
where XLA's fused multiply-adds and PyTorch's separate roundings may fall
on opposite sides.

The CUDA kernels themselves have no CPU version; ``test_cuda_kernels_match_plain``
(at B=1, 2 and 64), ``test_cuda_level_kernel_every_geometry`` and
``test_cuda_fused_kernel_every_geometry`` hold them against the plain
versions on a GPU and skip without one (the pyramid kernel's:
``tests/test_torch_pyramid_kernel.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.io import synthetic
from dense_visual_odometry_torch.models import robust
from dense_visual_odometry_torch.ops.cuda import fused_iter as tfused
from dense_visual_odometry_torch.ops.cuda import level_solver as tlevel
from dense_visual_odometry_torch.ops.cuda import pyramid as tpyrk
from dense_visual_odometry_torch.ops.cuda import stackwarp as tstack
from dense_visual_odometry_torch.ops.shiftwarp import residual_displacements, tent_sample
from dense_visual_odometry_torch.utils.lie import se3
from dense_visual_odometry_tpu.ops import residuals as jresiduals
from dense_visual_odometry_tpu.ops.pallas import fused_iter as jfused
from dense_visual_odometry_tpu.ops.pallas import level_solver as jlevel

GRID_H, GRID_W = 30, 40
CFG = RobustDVOConfig(
    levels=1, use_weighter=True, max_iterations=12, grid_strides=(1,),
    shift_stack_radius=3, shift_stack_levels=(0,), lm_lambda0=1e-4,
    approximate_image2_gradient=True, use_fused_iteration=True,
    freeze_shift_window=True, use_level_kernel=True,
)


def _frozen(stride: int, device="cpu", batch=2):
    """Level inputs for B pairs of a seeded scene (two pairs, repeated),
    frozen at a start pose."""
    h, w = GRID_H * stride, GRID_W * stride
    gray, depth, k = synthetic.textured_scene(h, w, seed=3)
    poses = synthetic.handheld_trajectory(3, seed=4, t_step=0.02, r_step=0.01)
    grays, depths = synthetic.render_sequence(gray, depth, k, poses)
    cam = CameraModel.create(k, 1.0)
    frames = [
        robust.preprocess_frame(g, d, cam, levels=1, device=device)
        for g, d in zip(grays, depths)
    ]
    pairs = ([(0, 1), (2, 1)] * batch)[:batch]
    prev_g = torch.stack([frames[i].gray[0] for i, _ in pairs])
    prev_d = torch.stack([frames[i].depth_m[0] for i, _ in pairs])
    curr_g = torch.stack([frames[j].gray[0] for _, j in pairs])
    gt = torch.as_tensor(
        np.stack([np.linalg.inv(poses[j]) @ poses[i] for i, j in pairs]),
        dtype=torch.float32, device=device,
    )
    rng = np.random.default_rng(stride)
    xi = torch.as_tensor(rng.normal(0, 4e-3, (batch, 6)), dtype=torch.float32, device=device)
    est0 = se3.exp(xi) @ gt
    cfg = dataclasses.replace(CFG, grid_strides=(stride,))
    k_t = cam.at(0).to(device)
    fl = robust.prepare_level(prev_g, prev_d, curr_g, k_t, est0, cfg, 0)
    return cfg, fl, k_t, est0, (h, w)


def _kernel_kwargs(cfg, image_hw, illum):
    """``lm_level``'s keyword arguments: the configuration's level-0 settings
    on an image of ``image_hw``, under the illumination ``illum``."""
    return dict(robust.kernel_settings(cfg, 0), image_h=image_hw[0], image_w=image_hw[1],
                illum_bias=illum == "bias", illum_affine=illum == "affine")


@pytest.fixture(scope="module", params=[1, 2], ids=["s1", "s2"])
def level_case(request):
    return (request.param,) + _frozen(request.param)


@pytest.mark.parametrize("rel", [None, 0.01], ids=["abs_tol", "rel_tol"])
@pytest.mark.parametrize("illum", [None, "bias", "affine"], ids=["no_illum", "bias", "affine"])
def test_level_solver_plain_matches_pallas(level_case, illum, rel):
    stride, cfg, fl, k, est0, image_hw = level_case
    b = est0.shape[0]
    wlam0 = torch.full((b,), 0.04)
    relt = None if rel is None else torch.full((b,), rel)
    points, scal = tlevel.level_inputs(fl.cu, fl.cv, fl.depth_prev_m, k, est0, est0, wlam0, relt, stride)
    kw = _kernel_kwargs(cfg, image_hw, illum)
    args = (fl.planes, points, fl.gray_prev, fl.jac_planes, scal)
    before = tlevel.lm_level.launches
    out_t = tlevel.lm_level(*args, **kw).numpy()
    assert tlevel.lm_level.launches == before  # CPU tensors: the plain version
    out_j = np.asarray(
        jlevel.lm_level_pallas(*(jnp.asarray(a.numpy()) for a in args), interpret=True, **kw)
    )
    its_t, its_j = out_t[:, 36], out_j[:, 36]
    np.testing.assert_array_equal(its_t, its_j)
    assert its_t.min() >= 2  # the LM loop really iterated
    np.testing.assert_allclose(out_t[:, 0:16], out_j[:, 0:16], atol=1e-5)
    np.testing.assert_allclose(out_t[:, 16:32], out_j[:, 16:32], atol=1e-5)
    np.testing.assert_allclose(out_t[:, 32:36], out_j[:, 32:36], rtol=1e-4)
    np.testing.assert_array_equal(out_t[:, 37:], out_j[:, 37:])


def _fused_kwargs(cfg, image_hw, illum):
    """``fused_evaluation``'s keyword arguments: the fused kernel's share of
    the configuration's level-0 settings, on an image of ``image_hw``."""
    return dict(tfused.fused_settings(robust.kernel_settings(cfg, 0)), image_h=image_hw[0],
                image_w=image_hw[1], illum_bias=illum == "bias")


def _fused_args(fl, k, pose, wlam, stride):
    """The fused kernel's inputs: the level's, with ``pose`` and ``wlam``
    in the scalar row."""
    points, scal = tlevel.level_inputs(fl.cu, fl.cv, fl.depth_prev_m, k, pose, pose, wlam, None,
                                       stride)
    return (fl.planes, points, fl.gray_prev, fl.jac_planes, scal)


def _pallas_shift_schur(out, illum_bias):
    """fused_iteration_pallas rows -> (hess, rhs, err, count, lam) as
    fused_shift_iteration reduces them (the bias Schur on the sums)."""
    b = out.shape[0]
    hess, rhs, err_sum, count = out[:, :36].reshape(b, 6, 6), out[:, 36:42], out[:, 42], out[:, 43]
    if illum_bias:
        s_safe = np.maximum(out[:, 45], 1e-6)
        rho, g = out[:, 46], out[:, 47:53]
        hess = hess - g[:, :, None] * g[:, None, :] / s_safe[:, None, None]
        rhs = rhs + g * (rho / s_safe)[:, None]
        err_sum = err_sum - rho * rho / s_safe
    return hess, rhs, err_sum / np.maximum(count, 1.0), count, out[:, 44]


@pytest.mark.parametrize("illum", [None, "bias"], ids=["no_illum", "bias"])
def test_fused_iteration_plain_matches_pallas(level_case, illum):
    """The lifted evaluation against the Pallas kernel on the displacements
    of the same pose: each field within 1e-4 of its largest magnitude, the
    valid count exact."""
    stride, cfg, fl, k, est0, image_hw = level_case
    wlam = torch.tensor([0.04, 0.02])
    args = _fused_args(fl, k, est0, wlam, stride)
    kw = _fused_kwargs(cfg, image_hw, illum)
    before = tfused.fused_evaluation.launches
    out_t = tfused.fused_evaluation(*args, **kw).numpy()
    assert tfused.fused_evaluation.launches == before  # CPU tensors: the plain version
    du, dv, valid = residual_displacements(
        fl.u0, fl.v0, fl.cu, fl.cv, cfg.shift_stack_radius, stride, *image_hw
    )
    valid = (valid & fl.valid_geom0).to(torch.float32)
    assert 0 < valid.sum() < valid.numel()
    pargs = (fl.planes, du, dv, fl.gray_prev, valid, fl.jac_planes, wlam[:, None])
    pkw = {n: v for n, v in kw.items() if n not in ("image_h", "image_w")}
    out_j = np.asarray(
        jfused.fused_iteration_pallas(*(jnp.asarray(a.numpy()) for a in pargs), interpret=True, **pkw)
    )
    hess, rhs, err, count, lam = _pallas_shift_schur(out_j, illum == "bias")
    fields = {"hess": (out_t[:, :36], hess.reshape(-1, 36)), "rhs": (out_t[:, 36:42], rhs),
              "err": (out_t[:, 42], err), "lam": (out_t[:, 44], lam)}
    for name, (a, b) in fields.items():
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name
    np.testing.assert_array_equal(out_t[:, 43], count)
    np.testing.assert_array_equal(out_t[:, 45:], 0.0)


@pytest.mark.parametrize("illum", [None, "bias"], ids=["no_illum", "bias"])
def test_fused_shift_iteration_matches(level_case, illum):
    """The solver-facing wrapper on a level's inputs against the JAX
    wrapper (frozen window, its own warp, bias Schur)."""
    stride, cfg, fl, k, est0, image_hw = level_case
    lam0 = torch.tensor([0.04, 0.02])
    kw = _fused_kwargs(cfg, image_hw, illum)
    inputs = tlevel.LevelInputs(*_fused_args(fl, k, est0, torch.ones(2), stride))
    t = tfused.fused_shift_iteration(inputs, est0, lam0, **kw)
    _, u, v, vg = jresiduals._warp_geometry(
        *(jnp.asarray(x.numpy()) for x in (fl.depth_prev_m, k, est0)), stride
    )
    curr_shape = jnp.zeros((2,) + image_hw)
    j = jfused.fused_shift_iteration(
        jnp.asarray(fl.gray_prev.numpy()), curr_shape, u, v, vg,
        jacobian_planes=jnp.asarray(fl.jac_planes.numpy()), lam0=jnp.asarray(lam0.numpy()),
        frozen=tuple(jnp.asarray(x.numpy()) for x in (fl.planes, fl.cu, fl.cv)),
        **{n: v for n, v in kw.items() if n not in ("image_h", "image_w")},
    )
    for a, b in zip(t, j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


def test_wrappers_raise_off_cpu_and_cuda():
    """Only CPU tensors take the plain versions; a device without a kernel raises."""
    meta = torch.device("meta")
    b, hp, wp, s, r = 1, 4, 5, 1, 3
    ph, pw = 2 * r + hp, 2 * r + wp
    z = lambda *shape: torch.zeros(shape, device=meta)  # noqa: E731
    args = (z(b, 1, ph, pw), z(b, 3, hp, wp), z(b, hp, wp), z(b, 6, hp, wp), z(b, 40))
    with pytest.raises(RuntimeError, match="no kernel"):
        tlevel.lm_level(*args, **_kernel_kwargs(CFG, (10, 10), None))
    with pytest.raises(RuntimeError, match="no kernel"):
        tfused.fused_evaluation(*args, radius=r, grid_stride=s, image_h=10, image_w=10)
    with pytest.raises(RuntimeError, match="no kernel"):
        tpyrk.median_pyr_down(z(b, hp, wp))


def test_wrappers_check_inputs():
    b, hp, wp, r = 1, 4, 5, 3
    good = dict(radius=r, grid_stride=1, image_h=10, image_w=10)
    planes = torch.zeros(b, 1, 2 * r + hp, 2 * r + wp)
    points = torch.zeros(b, 3, hp, wp)
    img = torch.zeros(b, hp, wp)
    jac = torch.zeros(b, 6, hp, wp)
    scal = torch.zeros(b, 40)
    with pytest.raises(ValueError, match="shape"):
        tfused.fused_evaluation(planes[:, :, 1:], points, img, jac, scal, **good)
    with pytest.raises(TypeError, match="float32"):
        tfused.fused_evaluation(planes, points, img.double(), jac, scal, **good)
    with pytest.raises(ValueError, match="contiguous"):
        tfused.fused_evaluation(planes, points, img, jac.transpose(2, 3).contiguous().transpose(2, 3),
                                scal, **good)
    # Every stride >= 1 is taken (the planes then have s^2 parity planes);
    # stride 0 is refused.
    with pytest.raises(ValueError, match="grid_stride must be >= 1"):
        tfused.fused_evaluation(planes, points, img, jac, scal, **{**good, "grid_stride": 0})
    with pytest.raises(ValueError, match="planes has shape"):
        tfused.fused_evaluation(planes, points, img, jac, scal, **{**good, "grid_stride": 3})


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 64], ids=["b1", "b2", "b64"])
@pytest.mark.parametrize("illum", [None, "bias", "affine"], ids=["no_illum", "bias", "affine"])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
def test_cuda_kernels_match_plain(stride, illum, batch):
    """Each CUDA kernel against its plain version on the card, same inputs
    (the fused kernel has no affine variant: bias there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU build")
    cfg, fl, k, est0, image_hw = _frozen(stride, device="cuda", batch=batch)
    b = est0.shape[0]
    wlam0 = torch.full((b,), 0.04, device="cuda")
    points, scal = tlevel.level_inputs(fl.cu, fl.cv, fl.depth_prev_m, k, est0, est0, wlam0,
                                       torch.full((b,), 0.01, device="cuda"), stride)
    kw = _kernel_kwargs(cfg, image_hw, illum)
    args = (fl.planes, points, fl.gray_prev, fl.jac_planes, scal)
    before = tlevel.lm_level.launches
    out_k = tlevel.lm_level(*args, **kw)
    assert tlevel.lm_level.launches == before + 1
    out_p = tlevel.lm_level_plain(*args, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out_k[:, 36].cpu(), out_p[:, 36].cpu())
    np.testing.assert_allclose(out_k[:, :32].cpu(), out_p[:, :32].cpu(), atol=1e-5)
    np.testing.assert_allclose(out_k[:, 32:36].cpu(), out_p[:, 32:36].cpu(), rtol=1e-4)

    # The fused kernel on the same inputs (bias for "affine": it has no
    # affine variant): valid counts equal, sums within 1e-4 of their largest.
    fkw = _fused_kwargs(cfg, image_hw, "bias" if illum else None)
    before = tfused.fused_evaluation.launches
    fk = tfused.fused_evaluation(*args, **fkw).cpu().numpy()
    assert tfused.fused_evaluation.launches == before + 1
    fp = tfused.fused_evaluation_plain(*args, **fkw).cpu().numpy()
    np.testing.assert_array_equal(fk[:, 43], fp[:, 43])
    scale = np.abs(fp).max(axis=0, keepdims=True) + 1e-30
    np.testing.assert_array_less(np.abs(fk - fp) / scale, 1e-4)

    du, dv, valid = residual_displacements(
        fl.u0, fl.v0, fl.cu, fl.cv, cfg.shift_stack_radius, stride, *image_hw
    )
    valid = (valid & fl.valid_geom0).to(torch.float32)

    before = tstack.stack_accumulate.launches
    sk = tstack.stack_accumulate(fl.planes, du.contiguous(), dv.contiguous(),
                                 cfg.shift_stack_radius, stride)
    assert tstack.stack_accumulate.launches == before + 1
    sp = tent_sample(fl.planes, du, dv, cfg.shift_stack_radius, stride)
    m = valid.cpu().numpy() > 0
    np.testing.assert_allclose(sk.cpu().numpy()[m], sp.cpu().numpy()[m], rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("illum", [None, "bias", "affine"], ids=["no_illum", "bias", "affine"])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
def test_cuda_level_kernel_every_geometry(stride, illum):
    """The level kernel at every cluster size, with resident and streamed
    inputs, against the plain version on the card: transforms 1e-5,
    iterations and valid counts identical, err and lambda 1e-3 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU build")
    cfg, fl, k, est0, image_hw = _frozen(stride, device="cuda", batch=3)
    b, hp, wp = fl.gray_prev.shape
    wlam0 = torch.full((b,), 0.04, device="cuda")
    points, scal = tlevel.level_inputs(fl.cu, fl.cv, fl.depth_prev_m, k, est0, est0, wlam0,
                                       torch.full((b,), 0.01, device="cuda"), stride)
    kw = _kernel_kwargs(cfg, image_hw, illum)
    args = (fl.planes, points, fl.gray_prev, fl.jac_planes, scal)
    out_p = tlevel.lm_level_plain(*args, **kw).cpu()
    for geo in tlevel.geometries(hp, wp, tlevel.LEVEL_KERNEL):
        out_k = tlevel._launch(*args, **kw, geometry=geo).cpu()
        np.testing.assert_array_equal(out_k[:, 35:37], out_p[:, 35:37])
        np.testing.assert_allclose(out_k[:, :32], out_p[:, :32], atol=1e-5)
        np.testing.assert_allclose(out_k[:, 32:35], out_p[:, 32:35], rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("illum", [None, "bias"], ids=["no_illum", "bias"])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
def test_cuda_fused_kernel_every_geometry(stride, illum):
    """The fused kernel at every cluster size against the plain version on
    the card: every field equal bit for bit (both add in float64 and round
    once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU build")
    cfg, fl, k, est0, image_hw = _frozen(stride, device="cuda", batch=3)
    b, hp, wp = fl.gray_prev.shape
    args = _fused_args(fl, k, est0, torch.full((b,), 0.04, device="cuda"), stride)
    kw = _fused_kwargs(cfg, image_hw, illum)
    out_p = tfused.fused_evaluation_plain(*args, **kw).cpu()
    for geo in tlevel.geometries(hp, wp, tfused.FUSED_KERNEL):
        out_k = tfused._launch(*args, **kw, geometry=geo).cpu()
        np.testing.assert_array_equal(out_k, out_p)
