"""The level kernel's row blocks, tiles and anisotropic ball: the plain
version against the JAX package's Pallas kernel.

``solve_level_fused`` of the port (``n_blocks``, ``n_blocks_x``, ``radius_y``
of ``robust.kernel_settings``) on
CPU tensors (the plain version, ``lm_level_plain``, on one window per
block) against the JAX package's ``solve_level_fused`` with the same
arguments (its slab and tile mosaics, Pallas interpreted), as
``test_torch_level_depth_prior.py`` holds the depth term and the prior: a
seeded synthetic scene seen from a second pose, B=2 on a 30x40 grid, grid
strides 1 and 2, the solves starting from the truth off by a seeded twist.
Both packages get the same centres (the port's ``prepare_level`` at the start
pose; ``test_torch_recenter_blocks.py`` holds them equal to the JAX
package's) and extract their own windows around them.

- Row blocks: 4 blocks with the vertical radius 2, and 9 blocks, which
  ``block_layout`` makes 8 of 4 rows.
- Tiles: 3 x 4 with the vertical radius 2.
- Illumination none, "bias" and "affine", and the depth term (the current
  depth's windows at the same centres).

Tolerances: transforms 1e-5 absolute; iteration counts identical; err,
count and the IRLS lambda 1e-4 relative.  ``test_cuda_block_kernel_matches_plain``
holds the CUDA kernel against the plain version on the card (B=1, 2 and 64)
and skips without one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.io import synthetic
from dense_visual_odometry_torch.models import robust
from dense_visual_odometry_torch.ops import gradients
from dense_visual_odometry_torch.ops.cuda import level_solver as tlevel
from dense_visual_odometry_torch.utils.lie import se3
from dense_visual_odometry_tpu.ops.pallas import level_solver as jlevel
from dense_visual_odometry_tpu.ops.pallas import stackwarp as jstack
from tests.test_torch_kernels import CFG, GRID_H, GRID_W, _kernel_kwargs

# name -> (recenter_blocks, recenter_col_blocks, shift_stack_radius_y)
LAYOUTS = {"rows4_ry2": (4, None, 2), "rows9": (9, None, None), "tiles3x4_ry2": (3, 4, 2)}
# (layout, illumination, depth term)
CASES = [
    ("rows4_ry2", None, False), ("rows4_ry2", "bias", False), ("rows9", "affine", False),
    ("tiles3x4_ry2", None, False), ("tiles3x4_ry2", "bias", False),
    ("tiles3x4_ry2", "affine", False), ("tiles3x4_ry2", None, True),
    ("rows4_ry2", "bias", True),
]


def block_case(stride, layout, device="cpu", batch=2):
    """A level of B pairs of a seeded scene under ``LAYOUTS[layout]``,
    frozen at a start pose near the truth: -> (cfg, frozen level, intrinsics,
    start pose, image size, previous depth's gradients)."""
    nb, nbx, ry = LAYOUTS[layout]
    h, w = GRID_H * stride, GRID_W * stride
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
    curr_d = torch.stack([frames[j].depth_m[0] for _, j in pairs])
    gt = torch.as_tensor(np.stack([np.linalg.inv(poses[j]) @ poses[i] for i, j in pairs]),
                         dtype=torch.float32, device=device)
    rng = np.random.default_rng(stride)
    xi = torch.as_tensor(rng.normal(0, 4e-3, (batch, 6)), dtype=torch.float32, device=device)
    est0 = se3.exp(xi) @ gt
    cfg = dataclasses.replace(CFG, grid_strides=(stride,), recenter_blocks=nb,
                              recenter_col_blocks=nbx, shift_stack_radius_y=ry)
    k_t = cam.at(0).to(device)
    plan = robust.level_plan(cfg, 0)
    assert plan.windows.tiles == (nbx is not None) and plan.windows.rows == (nbx is None)
    fl = robust.prepare_level(prev_g, prev_d, curr_g, k_t, est0, cfg, 0, depth_curr=curr_d)
    gzx, gzy = gradients.sobel(prev_d)
    zgrad = torch.stack([gzx / 8.0, gzy / 8.0], dim=1)[..., ::stride, ::stride].contiguous()
    return cfg, fl, k_t, est0, (h, w), zgrad, (prev_g, curr_g, curr_d)


def solve_both(stride, layout, illum, depth):
    """-> (port, JAX) results (est, anchor, wlam, err, count, iterations) of
    one level solve on the same inputs and centres."""
    cfg, fl, k_t, est0, image_hw, zgrad, (_, curr_g, curr_d) = block_case(stride, layout)
    plan = robust.level_plan(cfg, 0)
    b = est0.shape[0]
    wlam0 = torch.full((b,), 0.04)
    common = _kernel_kwargs(cfg, image_hw, illum)
    inputs = robust.kernel_inputs(fl, est0, est0, wlam0)._replace(
        depth_planes=fl.depth_planes if depth else None, zgrad=zgrad if depth else None)
    before = (tlevel.lm_level.launches, tlevel.lm_level.block_launches,
              tlevel.lm_level.tile_launches)
    out_t = tlevel.solve_level_fused(inputs, **common)
    assert (tlevel.lm_level.launches, tlevel.lm_level.block_launches,
            tlevel.lm_level.tile_launches) == before  # plain version: no kernel
    n = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    cu, cv = fl.cu.numpy(), fl.cv.numpy()
    hp, wp = fl.gray_prev.shape[-2:]
    r = cfg.shift_stack_radius
    blocks = plan.windows
    if blocks.tiles:
        extract = lambda img: jstack.extract_parity_planes_tiles(  # noqa: E731
            n(img), cu, cv, hp, wp, r, stride, blocks.n_blocks, blocks.n_blocks_x,
            radius_y=blocks.radius_y)
    else:
        extract = lambda img: jstack.extract_parity_planes_blocks(  # noqa: E731
            n(img), cu, cv, hp, wp, r, stride, blocks.n_blocks, radius_y=blocks.radius_y)
    out_j = jlevel.solve_level_fused(
        extract(curr_g), cu, cv, n(fl.depth_prev_m), n(fl.gray_prev), n(fl.jac_planes),
        n(k_t), n(est0), n(est0), n(wlam0), None, interpret=True,
        depth_planes=extract(curr_d) if depth else None,
        zgrad=(n(zgrad[:, 0]), n(zgrad[:, 1])) if depth else None, **common)
    return [x.numpy() for x in out_t], [np.asarray(x) for x in out_j]


@pytest.mark.parametrize("layout, illum, depth", CASES,
                         ids=[f"{a}-{b or 'no_illum'}{'-depth' if d else ''}" for a, b, d in CASES])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
def test_block_level_solve_matches_pallas(stride, layout, illum, depth):
    (est, anchor, wlam, err, count, its), ref = solve_both(stride, layout, illum, depth)
    assert int(its) == int(ref[5])
    assert int(its) >= 2  # the LM loop really iterated
    np.testing.assert_allclose(est, ref[0], atol=1e-5)
    np.testing.assert_allclose(anchor, ref[1], atol=1e-5)
    np.testing.assert_allclose(wlam, ref[2], rtol=1e-4)
    np.testing.assert_allclose(err, ref[3], rtol=1e-4)
    np.testing.assert_allclose(count, ref[4], rtol=1e-4)


def test_block_inputs_are_checked():
    """Tile windows and centres take their own shapes: (B, blocks, s^2, ph,
    pw) planes and 40 + 2 blocks scalar-row columns, refused under another
    layout."""
    cfg, fl, k_t, est0, image_hw, _, _ = block_case(2, "tiles3x4_ry2")
    assert fl.planes.dim() == 5 and fl.planes.shape[1] == 12
    assert len(torch.unique(fl.cu)) > 1  # the tiles really differ
    kw = _kernel_kwargs(cfg, image_hw, None)
    wlam0 = torch.full((est0.shape[0],), 0.04)
    points, scal = tlevel.level_inputs(fl.cu, fl.cv, fl.depth_prev_m, k_t, est0, est0, wlam0,
                                       None, 2)
    assert scal.shape[1] == tlevel.IN_COLS + 2 * 12
    out = tlevel.lm_level(fl.planes, points, fl.gray_prev, fl.jac_planes, scal,
                          **dict(kw, n_blocks=3, n_blocks_x=4, radius_y=2))
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="planes has shape"):
        tlevel.lm_level(fl.planes, points, fl.gray_prev, fl.jac_planes, scal,
                        **dict(kw, n_blocks=4, n_blocks_x=1, radius_y=2))
    with pytest.raises(ValueError, match="scal has shape"):
        tlevel.lm_level(fl.planes, points, fl.gray_prev, fl.jac_planes,
                        scal[:, :40].contiguous(), **dict(kw, n_blocks=3, n_blocks_x=4, radius_y=2))
    with pytest.raises(ValueError, match="needs row blocks or tiles"):
        tlevel.lm_level(fl.planes, points, fl.gray_prev, fl.jac_planes, scal,
                        **dict(kw, n_blocks=1, n_blocks_x=1, radius_y=2))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 64], ids=["b1", "b2", "b64"])
@pytest.mark.parametrize("layout, illum, depth", CASES,
                         ids=[f"{a}-{b or 'no_illum'}{'-depth' if d else ''}" for a, b, d in CASES])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
def test_cuda_block_kernel_matches_plain(stride, layout, illum, depth, batch):
    """The CUDA level kernel with blocks or tiles against the plain version
    on the card, same inputs: transforms 1e-5, iterations equal, err, count
    and lambda 1e-4 relative; the launch is counted as a block or tile one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU build")
    cfg, fl, k_t, est0, image_hw, zgrad, _ = block_case(stride, layout, "cuda", batch)
    wlam0 = torch.full((batch,), 0.04, device="cuda")
    points, scal = tlevel.level_inputs(fl.cu, fl.cv, fl.depth_prev_m, k_t, est0, est0, wlam0,
                                       None, stride)
    kw = _kernel_kwargs(cfg, image_hw, illum)
    if depth:
        kw.update(depth_planes=fl.depth_planes, zgrad=zgrad, depth_weight=cfg.depth_weight,
                  depth_huber_delta=cfg.depth_huber_delta)
    args = (fl.planes, points, fl.gray_prev, fl.jac_planes, scal)
    counter = "tile_launches" if kw["n_blocks_x"] > 1 else "block_launches"
    before = getattr(tlevel.lm_level, counter)
    out_k = tlevel.lm_level(*args, **kw)
    assert getattr(tlevel.lm_level, counter) == before + 1
    out_p = tlevel.lm_level_plain(*args, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out_k[:, 36].cpu(), out_p[:, 36].cpu())
    np.testing.assert_allclose(out_k[:, :32].cpu(), out_p[:, :32].cpu(), atol=1e-5)
    np.testing.assert_allclose(out_k[:, 32:36].cpu(), out_p[:, 32:36].cpu(), rtol=1e-4)
