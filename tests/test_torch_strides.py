"""Grid strides 3 and 4: the kernels' plain versions against the JAX package.

The three kernels take any grid stride (``csrc/dvo_common.cuh``: strides 1
and 2 at compile time, every stride >= 3 in one runtime-stride variant).
Their plain versions are held here against the JAX package's Pallas kernels
at strides 3 and 4, the Pallas kernels in interpret mode as the JAX
package's own tests run them on the CPU; both sides get the same seeded
numpy inputs.  The images are no multiple of the stride in size (H' =
ceil(H / s)), as 640 columns at stride 3 are not.

- ``prepare_shift_stack`` (centres, parity planes, displacements, validity)
  equal to the JAX package's ``compute_recenter``, ``extract_parity_planes``
  and ``residual_displacements``; ``tent_sample`` (the stack kernel's plain
  version) within 1e-6 of ``stack_accumulate_pallas``, and bit for bit
  equal to the TPU kernel's full sweep in its own order (rows ascending;
  within a row by column parity plane, then by column) done in numpy: the
  order in which the kernel adds its <= 4 taps is the sweep's.
- Row blocks and tiles at strides 3 and 4: centres and coverage equal, and
  the windows sample alike (as ``test_torch_recenter_blocks.py`` holds them
  at strides 1 and 2).
- ``lm_level_plain`` against ``lm_level_pallas`` (illumination none, bias,
  affine), and the fused evaluation against ``fused_iteration_pallas`` and
  ``fused_shift_iteration``, with the bounds of ``test_torch_kernels.py``;
  one block and one tile level solve against the JAX ``solve_level_fused``
  with the bounds of ``test_torch_level_blocks.py``.

``test_cuda_stride_kernels_match_plain`` holds each CUDA kernel against its
plain version at both strides on the card and skips without one.
``test_torch_track_strides.py`` tracks whole pairs at these strides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.io import synthetic
from dense_visual_odometry_torch.models import robust
from dense_visual_odometry_torch.ops import blockwarp as tblock
from dense_visual_odometry_torch.ops import residuals as tres
from dense_visual_odometry_torch.ops import shiftwarp as tshift
from dense_visual_odometry_torch.ops.cuda import fused_iter as tfused
from dense_visual_odometry_torch.ops.cuda import level_solver as tlevel
from dense_visual_odometry_torch.ops.cuda import stackwarp as tstack
from dense_visual_odometry_torch.utils.lie import se3
from dense_visual_odometry_tpu.ops import residuals as jresiduals
from dense_visual_odometry_tpu.ops.pallas import fused_iter as jfused
from dense_visual_odometry_tpu.ops.pallas import level_solver as jlevel
from dense_visual_odometry_tpu.ops.pallas import stackwarp as jstack
from tests.test_torch_kernels import CFG, _fused_kwargs, _kernel_kwargs, _pallas_shift_schur
from tests.test_torch_level_blocks import solve_both
from tests.test_torch_recenter_blocks import field, sweep

STRIDES = [3, 4]
GRID_H, GRID_W, RADIUS = 30, 40, 3


def _t(x):
    return torch.tensor(np.asarray(x))


def _jx(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def image_size(s):
    """An image whose strided grid is GRID_H x GRID_W with a ragged last
    row and column (H = s (H' - 1) + 2)."""
    return s * (GRID_H - 1) + 2, s * (GRID_W - 1) + 2


def frozen(stride, device="cpu", batch=2):
    """A level of B pairs of a seeded scene, frozen at a start pose near
    the truth (``test_torch_kernels._frozen`` on a ragged image)."""
    h, w = image_size(stride)
    gray, depth, k = synthetic.textured_scene(h, w, seed=3)
    poses = synthetic.handheld_trajectory(3, seed=4, t_step=0.02, r_step=0.01)
    grays, depths = synthetic.render_sequence(gray, depth, k, poses)
    cam = CameraModel.create(k, 1.0)
    frames = [robust.preprocess_frame(g, d, cam, levels=1, device=device)
              for g, d in zip(grays, depths)]
    pairs = ([(0, 1), (2, 1)] * batch)[:batch]
    prev_g = torch.stack([frames[i].gray[0] for i, _ in pairs])
    prev_d = torch.stack([frames[i].depth_m[0] for i, _ in pairs])
    curr_g = torch.stack([frames[j].gray[0] for _, j in pairs])
    gt = torch.as_tensor(np.stack([np.linalg.inv(poses[j]) @ poses[i] for i, j in pairs]),
                         dtype=torch.float32, device=device)
    xi = np.random.default_rng(stride).normal(0, 4e-3, (batch, 6))
    est0 = se3.exp(torch.as_tensor(xi, dtype=torch.float32, device=device)) @ gt
    cfg = dataclasses.replace(CFG, grid_strides=(stride,))
    k_t = cam.at(0).to(device)
    fl = robust.prepare_level(prev_g, prev_d, curr_g, k_t, est0, cfg, 0)
    assert tuple(fl.gray_prev.shape[-2:]) == (GRID_H, GRID_W)
    return cfg, fl, k_t, est0, (h, w)


@pytest.fixture(scope="module", params=STRIDES, ids=["s3", "s4"])
def level_case(request):
    return (request.param,) + frozen(request.param)


@pytest.fixture(scope="module", params=STRIDES, ids=["s3", "s4"])
def warp_case(request):
    """The current image and the warp (u, v) of the strided grid at a
    seeded pose near the truth."""
    s = request.param
    h, w = image_size(s)
    gray, depth, k = synthetic.textured_scene(h, w, seed=7)
    poses = synthetic.handheld_trajectory(2, seed=8, t_step=0.02, r_step=0.01)
    grays, depths = synthetic.render_sequence(gray, depth, k, poses)
    depth_prev = torch.tensor(np.stack([depths[0], depths[1]]), dtype=torch.float32)
    gray_curr = torch.tensor(np.stack([grays[1], grays[0]]), dtype=torch.float32)
    gt = np.stack([np.linalg.inv(poses[1]) @ poses[0], np.linalg.inv(poses[0]) @ poses[1]])
    xi = np.random.default_rng(s).normal(0, 3e-3, (2, 6))
    transform = se3.exp(torch.tensor(xi, dtype=torch.float32)) @ torch.tensor(
        gt, dtype=torch.float32)
    _, u, v, vg = tres.warp_geometry(depth_prev[:, ::s, ::s], torch.tensor(k), transform, s)
    return s, gray_curr, u, v, vg


def test_shift_stack_matches_pallas(warp_case):
    s, img, u, v, vg = warp_case
    planes, du, dv, valid = tshift.prepare_shift_stack(img, u, v, RADIUS, s, vg)
    # The JAX package's own prepare_shift_stack refuses strides above 2 (its
    # "shift" evaluation then takes the XLA sweep); its pieces take any.
    jcu, jcv = jstack.compute_recenter(_jx(u), _jx(v), RADIUS, s, _jx(vg))
    j_du, j_dv, j_valid = jstack.residual_displacements(
        _jx(u), _jx(v), jcu, jcv, RADIUS, s, img.shape[-2], img.shape[-1])
    j_planes = jstack.extract_parity_planes(_jx(img), jcu, jcv, GRID_H, GRID_W, RADIUS, s)
    assert planes.shape == (2, s * s, 2 * RADIUS // s + GRID_H, 2 * RADIUS // s + GRID_W)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(j_planes))
    np.testing.assert_array_equal(du.numpy(), np.asarray(j_du))
    np.testing.assert_array_equal(dv.numpy(), np.asarray(j_dv))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    assert 0 < int(valid.sum()) < valid.numel()
    before = tstack.stack_accumulate.launches
    acc = tstack.stack_accumulate(planes, du.contiguous(), dv.contiguous(), RADIUS, s)
    assert tstack.stack_accumulate.launches == before  # CPU tensors: the plain version
    j_acc = np.asarray(jstack.stack_accumulate_pallas(j_planes, j_du, j_dv, RADIUS,
                                                      grid_stride=s, interpret=True))
    ok = valid.numpy()
    np.testing.assert_allclose(acc.numpy()[ok], j_acc[ok], rtol=1e-6, atol=1e-6 * 255)


def pallas_order_sweep(planes, du, dv, r, s):
    """The Pallas stack kernel's sweep in numpy float32 (no fused
    multiply-add): rows ky ascending, within a row column parity plane pb,
    then column kx; every tap of [-r, r]^2 added with its tent weight."""
    hp, wp = du.shape[-2:]
    i = np.arange(hp)[:, None]
    j = np.arange(wp)[None, :]
    out = np.zeros(du.shape, np.float32)
    for ky in range(-r, r + 1):
        a = r + ky
        wy = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(dv - np.float32(ky)))
        for pb in range(s):
            for kx in range(-r, r + 1):
                b = r + kx
                if b % s != pb:
                    continue
                wx = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(du - np.float32(kx)))
                val = planes[:, (a % s) * s + pb, a // s + i, b // s + j]
                out = out + (wy * wx) * val
    return out


@pytest.mark.parametrize("radius", [2, 3, 5])
@pytest.mark.parametrize("s", STRIDES, ids=["s3", "s4"])
def test_tent_sample_keeps_the_sweep_order(s, radius):
    """Inside the ball the plain sampler equals the sweep bit for bit: its
    two taps of a row are added in the sweep's order (the second first
    where the first lies in parity plane s - 1), and the zero-weight taps
    the sweep adds change nothing."""
    rng = np.random.default_rng(30 + s + radius)
    planes = rng.uniform(0, 255, (2, s * s, 2 * radius // s + GRID_H,
                                  2 * radius // s + GRID_W)).astype(np.float32)
    du = rng.uniform(-radius + 1e-3, radius - 1e-3, (2, GRID_H, GRID_W)).astype(np.float32)
    dv = rng.uniform(-radius + 1e-3, radius - 1e-3, (2, GRID_H, GRID_W)).astype(np.float32)
    got = tshift.tent_sample(_t(planes), _t(du), _t(dv), radius, s).numpy()
    np.testing.assert_array_equal(got, pallas_order_sweep(planes, du, dv, radius, s))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("kind", ["rows6", "tiles3x4"])
@pytest.mark.parametrize("s", STRIDES, ids=["s3", "s4"])
def test_block_centres_and_coverage(s, kind, masked):
    r, ry = 3, 2
    u, v, mask = field(s, masked, seed=2)
    m = mask if masked else None
    tm = None if m is None else _t(m)
    if kind == "rows6":
        jcu, jcv = jax.jit(lambda a, b, c: jstack.compute_recenter_blocks(
            a, b, r, s, 6, c, radius_y=ry))(u, v, m)
        tcu, tcv = tblock.compute_recenter_blocks(_t(u), _t(v), r, s, 6, tm, radius_y=ry)
        jcov = jax.jit(lambda a, b, c: jstack.shift_coverage_blocks(
            a, b, r, s, 6, c, radius_y=ry))(u, v, m)
        tcov = tblock.shift_coverage_blocks(_t(u), _t(v), r, s, 6, tm, radius_y=ry)
    else:
        jcu, jcv = jax.jit(lambda a, b, c: jstack.compute_recenter_tiles(
            a, b, r, s, 3, 4, c, radius_y=ry))(u, v, m)
        tcu, tcv = tblock.compute_recenter_tiles(_t(u), _t(v), r, s, 3, 4, tm, radius_y=ry)
        jcov = jax.jit(lambda a, b, c: jstack.shift_coverage_tiles(
            a, b, r, s, 3, 4, c, radius_y=ry))(u, v, m)
        tcov = tblock.shift_coverage_tiles(_t(u), _t(v), r, s, 3, 4, tm, radius_y=ry)
    np.testing.assert_array_equal(tcu.numpy(), np.asarray(jcu))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(jcv))
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), rtol=1e-6)


@pytest.mark.parametrize("kind", ["rows6", "tiles3x4"])
@pytest.mark.parametrize("s", STRIDES, ids=["s3", "s4"])
def test_block_windows_sample_alike(s, kind):
    """At strides 3 and 4 the port's block and tile windows, sampled by
    ``tent_sample`` with their layout, equal the JAX package's mosaic swept
    tap by tap (``extract_parity_planes_blocks`` / ``_tiles``), at the same
    centres and displacements; the halo is 2 r_y // s rows and 2 r // s
    columns."""
    r, ry = 3, 2
    b, hp, wp = 2, GRID_H, GRID_W
    rng = np.random.default_rng(20 + s)
    image = rng.uniform(0, 255, (b,) + image_size(s)).astype(np.float32)
    if kind == "rows6":
        nby, t_y, halo_y = jstack.block_layout(hp, 6, ry, s)
        nbx, t_x, halo_x = 1, wp, 2 * r // s
        cu = rng.integers(-4 * r, 4 * r + 1, (b, nby)).astype(np.int32)
        cv = rng.integers(-4 * r, 4 * r + 1, (b, nby)).astype(np.int32)
        jpl = np.asarray(jax.jit(lambda i, a, c: jstack.extract_parity_planes_blocks(
            i, a, c, hp, wp, r, s, 6, radius_y=ry))(image, cu, cv))
        win = jpl.reshape(b, s * s, nby, t_y + halo_y, -1).transpose(0, 2, 1, 3, 4)[:, :, None]
        tpl = tblock.window_planes(_t(image), _t(cu), _t(cv), hp, wp, r, s,
                                   tblock.Blocks(6, 1, ry))
        layout = tshift.window_layout(hp, wp, r, s, 6, 1, ry)
    else:
        nby, t_y, halo_y, nbx, t_x, halo_x = jstack.tile_layout(hp, wp, 3, 4, r, ry, s)
        cu = rng.integers(-4 * r, 4 * r + 1, (b, nby, nbx)).astype(np.int32)
        cv = rng.integers(-4 * r, 4 * r + 1, (b, nby, nbx)).astype(np.int32)
        jpl = np.asarray(jax.jit(lambda i, a, c: jstack.extract_parity_planes_tiles(
            i, a, c, hp, wp, r, s, 3, 4, radius_y=ry))(image, cu, cv))
        win = jpl.reshape(b, s * s, nby, t_y + halo_y, nbx, t_x + halo_x).transpose(
            0, 2, 4, 1, 3, 5)
        tpl = tblock.window_planes(_t(image), _t(cu), _t(cv), hp, wp, r, s,
                                   tblock.Blocks(3, 4, ry))
        layout = tshift.window_layout(hp, wp, r, s, 3, 4, ry)
    assert (halo_y, halo_x) == (2 * ry // s, 2 * r // s)
    assert (layout.nby, layout.t_y, layout.nbx, layout.t_x) == (nby, t_y, nbx, t_x)
    assert tuple(tpl.shape) == (b, nby * nbx, s * s, t_y + halo_y, t_x + halo_x)
    du = rng.uniform(-r + 1e-3, r - 1e-3, (b, hp, wp)).astype(np.float32)
    dv = rng.uniform(-ry + 1e-3, ry - 1e-3, (b, hp, wp)).astype(np.float32)
    ref = sweep(win, t_y, t_x, du, dv, r, ry, s)
    got = tshift.tent_sample(tpl, _t(du), _t(dv), r, s, layout).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("illum", [None, "bias", "affine"], ids=["no_illum", "bias", "affine"])
def test_level_solver_plain_matches_pallas(level_case, illum):
    stride, cfg, fl, k, est0, image_hw = level_case
    b = est0.shape[0]
    wlam0 = torch.full((b,), 0.04)
    points, scal = tlevel.level_inputs(fl.cu, fl.cv, fl.depth_prev_m, k, est0, est0, wlam0,
                                       torch.full((b,), 0.01), stride)
    kw = _kernel_kwargs(cfg, image_hw, illum)
    args = (fl.planes, points, fl.gray_prev, fl.jac_planes, scal)
    before = tlevel.lm_level.launches
    out_t = tlevel.lm_level(*args, **kw).numpy()
    assert tlevel.lm_level.launches == before  # CPU tensors: the plain version
    out_j = np.asarray(
        jlevel.lm_level_pallas(*(jnp.asarray(a.numpy()) for a in args), interpret=True, **kw))
    np.testing.assert_array_equal(out_t[:, 36], out_j[:, 36])
    assert out_t[:, 36].min() >= 2  # the LM loop really iterated
    np.testing.assert_allclose(out_t[:, 0:32], out_j[:, 0:32], atol=1e-5)
    np.testing.assert_allclose(out_t[:, 32:36], out_j[:, 32:36], rtol=1e-4)


@pytest.mark.parametrize("illum", [None, "bias"], ids=["no_illum", "bias"])
def test_fused_evaluation_plain_matches_pallas(level_case, illum):
    """The fused kernel's plain version against the Pallas kernel on the
    displacements of the same pose: each field within 1e-4 of its largest
    magnitude, the valid count exact; and the solver-facing wrapper
    against the JAX package's ``fused_shift_iteration``."""
    stride, cfg, fl, k, est0, image_hw = level_case
    wlam = torch.tensor([0.04, 0.02])
    points, scal = tlevel.level_inputs(fl.cu, fl.cv, fl.depth_prev_m, k, est0, est0, wlam,
                                       None, stride)
    kw = _fused_kwargs(cfg, image_hw, illum)
    before = tfused.fused_evaluation.launches
    out_t = tfused.fused_evaluation(fl.planes, points, fl.gray_prev, fl.jac_planes, scal,
                                    **kw).numpy()
    assert tfused.fused_evaluation.launches == before
    du, dv, valid = tshift.residual_displacements(
        fl.u0, fl.v0, fl.cu, fl.cv, cfg.shift_stack_radius, stride, *image_hw)
    valid = (valid & fl.valid_geom0).to(torch.float32)
    assert 0 < valid.sum() < valid.numel()
    pargs = (fl.planes, du, dv, fl.gray_prev, valid, fl.jac_planes, wlam[:, None])
    pkw = {n: v for n, v in kw.items() if n not in ("image_h", "image_w")}
    out_j = np.asarray(jfused.fused_iteration_pallas(
        *(jnp.asarray(a.numpy()) for a in pargs), interpret=True, **pkw))
    hess, rhs, err, count, lam = _pallas_shift_schur(out_j, illum == "bias")
    fields = {"hess": (out_t[:, :36], hess.reshape(-1, 36)), "rhs": (out_t[:, 36:42], rhs),
              "err": (out_t[:, 42], err), "lam": (out_t[:, 44], lam)}
    for name, (a, ref) in fields.items():
        assert np.abs(a - ref).max() <= 1e-4 * np.abs(ref).max(), name
    np.testing.assert_array_equal(out_t[:, 43], count)

    inputs = tlevel.LevelInputs(fl.planes, points, fl.gray_prev, fl.jac_planes, scal)
    t = tfused.fused_shift_iteration(inputs, est0, wlam, **kw)
    _, u, v, vg = jresiduals._warp_geometry(
        *(jnp.asarray(x.numpy()) for x in (fl.depth_prev_m, k, est0)), stride)
    j = jfused.fused_shift_iteration(
        jnp.asarray(fl.gray_prev.numpy()), jnp.zeros((2,) + image_hw), u, v, vg,
        jacobian_planes=jnp.asarray(fl.jac_planes.numpy()), lam0=jnp.asarray(wlam.numpy()),
        frozen=tuple(jnp.asarray(x.numpy()) for x in (fl.planes, fl.cu, fl.cv)), **pkw)
    for a, ref in zip(t, j):
        ref = np.asarray(ref)
        np.testing.assert_allclose(a.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("layout, illum", [("rows4_ry2", "bias"), ("tiles3x4_ry2", None)])
def test_stride3_block_level_solve_matches_pallas(layout, illum):
    (est, anchor, wlam, err, count, its), ref = solve_both(3, layout, illum, False)
    assert int(its) == int(ref[5]) and int(its) >= 2
    np.testing.assert_allclose(est, ref[0], atol=1e-5)
    np.testing.assert_allclose(anchor, ref[1], atol=1e-5)
    np.testing.assert_allclose(wlam, ref[2], rtol=1e-4)
    np.testing.assert_allclose(err, ref[3], rtol=1e-4)
    np.testing.assert_allclose(count, ref[4], rtol=1e-4)


def test_no_stride_below_one():
    """Stride 0 is refused by every wrapper (the C entry points return an
    error code for it too)."""
    planes = torch.zeros(1, 1, 10, 10)
    du = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="grid_stride must be >= 1"):
        tstack.stack_accumulate(planes, du, du, 3, 0)
    img = torch.zeros(1, 10, 10)
    with pytest.raises(ValueError, match="grid_stride must be >= 1"):
        tshift.prepare_shift_stack(img, du, du, 3, 0, torch.ones(1, 4, 4, dtype=torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 64], ids=["b1", "b2", "b64"])
@pytest.mark.parametrize("s", STRIDES, ids=["s3", "s4"])
def test_cuda_stride_kernels_match_plain(s, batch):
    """Each CUDA kernel against its plain version on the card at strides 3
    and 4: the stack kernel bit for bit, the level kernel (none, bias,
    affine) with iterations equal and transforms within 1e-5, the fused
    kernel within 1e-4 of each field's largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU build")
    cfg, fl, k, est0, image_hw = frozen(s, "cuda", batch)
    wlam = torch.full((batch,), 0.04, device="cuda")
    points, scal = tlevel.level_inputs(fl.cu, fl.cv, fl.depth_prev_m, k, est0, est0, wlam,
                                       None, s)
    args = (fl.planes, points, fl.gray_prev, fl.jac_planes, scal)
    du = (fl.u0 - fl.cu[:, None, None]).contiguous()
    dv = (fl.v0 - fl.cv[:, None, None]).contiguous()
    got = tstack.stack_accumulate(fl.planes, du, dv, cfg.shift_stack_radius, s)
    want = tshift.tent_sample(fl.planes, du, dv, cfg.shift_stack_radius, s)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    for illum in (None, "bias", "affine"):
        kw = _kernel_kwargs(cfg, image_hw, illum)
        out_k, out_p = tlevel.lm_level(*args, **kw), tlevel.lm_level_plain(*args, **kw)
        np.testing.assert_array_equal(out_k[:, 36].cpu(), out_p[:, 36].cpu())
        np.testing.assert_allclose(out_k[:, :32].cpu(), out_p[:, :32].cpu(), atol=1e-5)
    for illum in (None, "bias"):
        kw = _fused_kwargs(cfg, image_hw, illum)
        out_k = tfused.fused_evaluation(*args, **kw).cpu().numpy()
        out_p = tfused.fused_evaluation_plain(*args, **kw).cpu().numpy()
        assert np.abs(out_k - out_p).max() <= 1e-4 * np.abs(out_p).max()
