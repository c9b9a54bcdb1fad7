"""Row-block and tile recentring of the port against the JAX package.

``ops/blockwarp.py`` and the layouts of ``ops/shiftwarp.py`` against
``dense_visual_odometry_tpu/ops/pallas/stackwarp.py`` on the same seeded
numpy inputs: a displacement field with a rotation-like spread across the
grid (so that blocks take different centres), noise, and a coordinate mask
that leaves some blocks with fewer than 8 valid pixels (they take the global
mean).  Parametrised over block counts (one that ``block_layout`` shrinks:
9 blocks of a 30-row grid are 8 of 4 rows), radii (isotropic and with a
smaller vertical radius), grid strides 1 and 2, with and without the mask,
and for tiles a clip bound that binds.

Centres are integers and must be equal; coverages agree to 1e-6 relative
(float32 sums in another order).  The windows are held by what they are
for, not by layout: the JAX package's mosaic (halo rows and columns) and
the port's one window per block give equal tent samples of every grid pixel
at the same displacements inside the ball, the JAX side by a full
(2r_y+1)(2r+1) tap sweep over its own planes in numpy.
"""

import jax
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.ops import blockwarp as tblock
from dense_visual_odometry_torch.ops import shiftwarp as tshift
from dense_visual_odometry_tpu.ops.pallas import stackwarp as jstack

B, HP, WP = 2, 30, 40
RADII = [(3, 3), (3, 2), (2, 1)]
ROW_BLOCKS = [2, 4, 6, 9]  # 9 of 30 rows: block_layout makes 8 blocks of 4
TILES = [(3, 4), (8, 10), (1, 5)]


def _t(x):
    return torch.tensor(np.asarray(x))


def field(stride, masked, seed=0):
    """u, v (B, H', W') full-resolution coordinates of a grid whose
    displacement turns across it (a few pixels from corner to corner), and
    a coordinate mask that empties one corner."""
    rng = np.random.default_rng(seed + 10 * stride + masked)
    col = np.arange(WP, dtype=np.float32)[None, None, :] * stride
    row = np.arange(HP, dtype=np.float32)[None, :, None] * stride
    theta = np.float32(0.06 + 0.02 * np.arange(B, dtype=np.float32))[:, None, None]
    du = 2.7 - theta * (row - HP * stride / 2) + rng.normal(0, 0.3, (B, HP, WP))
    dv = -1.4 + theta * (col - WP * stride / 2) + rng.normal(0, 0.3, (B, HP, WP))
    u = (col + du).astype(np.float32)
    v = (row + dv).astype(np.float32)
    mask = np.ones((B, HP, WP), bool)
    if masked:
        mask &= rng.uniform(size=(B, HP, WP)) > 0.3
        mask[:, :9, :12] = False  # a corner without (enough) valid pixels
        mask[:, :4, :] = False  # and the first rows
    return u, v, mask


@pytest.mark.parametrize("grid_hp, n_blocks, radius_y, stride",
                         [(30, 4, 3, 1), (9, 4, 2, 2), (30, 9, 1, 1), (7, 20, 3, 2), (30, 1, 3, 1)])
def test_block_layout_matches(grid_hp, n_blocks, radius_y, stride):
    assert tshift.block_layout(grid_hp, n_blocks, radius_y, stride) == jstack.block_layout(
        grid_hp, n_blocks, radius_y, stride)
    assert tshift.block_layout(9, 4, 3, 1)[:2] == (3, 3)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
@pytest.mark.parametrize("radii", RADII, ids=lambda r: f"r{r[0]}ry{r[1]}")
@pytest.mark.parametrize("n_blocks", ROW_BLOCKS)
def test_row_block_centres_and_coverage(n_blocks, radii, stride, masked):
    r, ry = radii
    u, v, mask = field(stride, masked)
    m = mask if masked else None
    jcu, jcv = jax.jit(lambda a, b, c: jstack.compute_recenter_blocks(
        a, b, r, stride, n_blocks, c, radius_y=ry))(u, v, m)
    tcu, tcv = tblock.compute_recenter_blocks(_t(u), _t(v), r, stride, n_blocks,
                                              None if m is None else _t(m), radius_y=ry)
    assert tcu.dtype == torch.int32
    np.testing.assert_array_equal(tcu.numpy(), np.asarray(jcu))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(jcv))
    assert len(np.unique(np.asarray(jcu))) > 1  # the blocks really differ
    jcov = jax.jit(lambda a, b, c: jstack.shift_coverage_blocks(
        a, b, r, stride, n_blocks, c, radius_y=ry))(u, v, m)
    tcov = tblock.shift_coverage_blocks(_t(u), _t(v), r, stride, n_blocks,
                                        None if m is None else _t(m), radius_y=ry)
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), rtol=1e-6)


@pytest.mark.parametrize("center_bound", [None, 2], ids=["default_bound", "bound2"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
@pytest.mark.parametrize("radii", RADII, ids=lambda r: f"r{r[0]}ry{r[1]}")
@pytest.mark.parametrize("tiles", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_tile_centres_and_coverage(tiles, radii, stride, masked, center_bound):
    r, ry = radii
    nby, nbx = tiles
    u, v, mask = field(stride, masked, seed=1)
    m = mask if masked else None
    jcu, jcv = jax.jit(lambda a, b, c: jstack.compute_recenter_tiles(
        a, b, r, stride, nby, nbx, c, radius_y=ry, center_bound=center_bound))(u, v, m)
    tcu, tcv = tblock.compute_recenter_tiles(_t(u), _t(v), r, stride, nby, nbx,
                                             None if m is None else _t(m), radius_y=ry,
                                             center_bound=center_bound)
    np.testing.assert_array_equal(tcu.numpy(), np.asarray(jcu))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(jcv))
    if center_bound is not None:
        assert np.abs(np.asarray(jcu)).max() == center_bound  # the clip binds
    jcov = jax.jit(lambda a, b, c: jstack.shift_coverage_tiles(
        a, b, r, stride, nby, nbx, c, radius_y=ry, center_bound=center_bound))(u, v, m)
    tcov = tblock.shift_coverage_tiles(_t(u), _t(v), r, stride, nby, nbx,
                                       None if m is None else _t(m), radius_y=ry,
                                       center_bound=center_bound)
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), rtol=1e-6)


def sweep(windows, t_y, t_x, du, dv, r, ry, s):
    """The TPU kernels' full tap sweep in numpy: grid pixel (i, j) of block
    (k, l) adds every tap (ky, kx) of [-ry, ry] x [-r, r] of its block's
    window ``windows[b, k, l]`` (s^2 parity planes) with its tent weight."""
    hp, wp = du.shape[-2:]
    k = (np.arange(hp) // t_y)[:, None]
    l = (np.arange(wp) // t_x)[None, :]
    il = np.arange(hp)[:, None] - k * t_y
    jl = np.arange(wp)[None, :] - l * t_x
    out = np.zeros(du.shape, np.float32)
    for ky in range(-ry, ry + 1):
        a = ry + ky
        wy = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(dv - np.float32(ky)))
        for kx in range(-r, r + 1):
            c = r + kx
            wx = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(du - np.float32(kx)))
            val = windows[:, k, l, (a % s) * s + c % s, a // s + il, c // s + jl]
            out = out + (wy * wx) * val
    return out


@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
@pytest.mark.parametrize("radii", RADII, ids=lambda r: f"r{r[0]}ry{r[1]}")
@pytest.mark.parametrize("kind", ["rows6", "rows9", "tiles3x4", "tiles8x10"])
def test_block_windows_sample_alike(kind, radii, stride):
    """The port's windows, sampled by ``tent_sample`` with their layout,
    equal the JAX package's mosaic swept tap by tap, at the same centres
    and displacements."""
    r, ry = radii
    s = stride
    rng = np.random.default_rng(20 + s)
    image = rng.uniform(0, 255, (B, HP * s, WP * s)).astype(np.float32)
    if kind.startswith("rows"):
        nb = int(kind[4:])
        nby, t_y, halo_y = jstack.block_layout(HP, nb, ry, s)
        nbx, t_x, halo_x = 1, WP, 2 * r // s
        cu = rng.integers(-4 * r, 4 * r + 1, (B, nby)).astype(np.int32)
        cv = rng.integers(-4 * r, 4 * r + 1, (B, nby)).astype(np.int32)
        jpl = np.asarray(jax.jit(lambda i, a, b: jstack.extract_parity_planes_blocks(
            i, a, b, HP, WP, r, s, nb, radius_y=ry))(image, cu, cv))
        # (B, s^2, nby*slab_h, pw) -> [b, k, 0] = (s^2, slab_h, pw)
        win = jpl.reshape(B, s * s, nby, t_y + halo_y, -1).transpose(0, 2, 1, 3, 4)[:, :, None]
        tpl = tblock.window_planes(_t(image), _t(cu), _t(cv), HP, WP, r, s,
                                   tblock.Blocks(nb, 1, ry))
        layout = tshift.window_layout(HP, WP, r, s, nb, 1, ry)
    else:
        nb, nbxc = (int(x) for x in kind[5:].split("x"))
        nby, t_y, halo_y, nbx, t_x, halo_x = jstack.tile_layout(HP, WP, nb, nbxc, r, ry, s)
        bound = 4 * r
        cu = rng.integers(-bound, bound + 1, (B, nby, nbx)).astype(np.int32)
        cv = rng.integers(-bound, bound + 1, (B, nby, nbx)).astype(np.int32)
        jpl = np.asarray(jax.jit(lambda i, a, b: jstack.extract_parity_planes_tiles(
            i, a, b, HP, WP, r, s, nb, nbxc, radius_y=ry))(image, cu, cv))
        # (B, s^2, nby*slab_h, nbx*slab_w) -> [b, k, l] = (s^2, slab_h, slab_w)
        win = jpl.reshape(B, s * s, nby, t_y + halo_y, nbx, t_x + halo_x).transpose(
            0, 2, 4, 1, 3, 5)
        tpl = tblock.window_planes(_t(image), _t(cu), _t(cv), HP, WP, r, s,
                                   tblock.Blocks(nb, nbxc, ry))
        layout = tshift.window_layout(HP, WP, r, s, nb, nbxc, ry)
    assert (layout.nby, layout.t_y, layout.nbx, layout.t_x) == (nby, t_y, nbx, t_x)
    assert tuple(tpl.shape) == (B, nby * nbx, s * s, t_y + halo_y, t_x + halo_x)
    du = rng.uniform(-r + 1e-3, r - 1e-3, (B, HP, WP)).astype(np.float32)
    dv = rng.uniform(-ry + 1e-3, ry - 1e-3, (B, HP, WP)).astype(np.float32)
    ref = sweep(win, t_y, t_x, du, dv, r, ry, s)
    got = tshift.tent_sample(tpl, _t(du), _t(dv), r, s, layout).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)


def test_one_block_is_the_single_window():
    """One block's layout is the single-centre window's, and ``tent_sample``
    reads it alike with or without the layout."""
    s, r = 2, 3
    layout = tshift.window_layout(HP, WP, r, s)
    assert (layout.blocks, layout.ph, layout.pw) == (1, 2 * r // s + HP, 2 * r // s + WP)
    rng = np.random.default_rng(3)
    image = _t(rng.uniform(0, 255, (B, HP * s, WP * s)).astype(np.float32))
    cu, cv = _t(np.array([2, -3], np.int32)), _t(np.array([-1, 4], np.int32))
    planes = tshift.extract_parity_planes(image, cu, cv, HP, WP, r, s)
    du = _t(rng.uniform(-r, r, (B, HP, WP)).astype(np.float32))
    dv = _t(rng.uniform(-r, r, (B, HP, WP)).astype(np.float32))
    torch.testing.assert_close(tshift.tent_sample(planes, du, dv, r, s, layout),
                               tshift.tent_sample(planes, du, dv, r, s), rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs row blocks or tiles"):
        tshift.window_layout(HP, WP, r, s, radius_y=2)
