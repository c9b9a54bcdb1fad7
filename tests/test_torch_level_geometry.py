"""The level kernel's launch geometry, on the CPU.

``level_geometry`` spreads each batch element of a level over a cluster of
C CTAs, CTA rank k on the template rows ``band_rows(hp, C)[k]``.  These
tests hold the rule to what the kernel needs at the main path's level
shapes (640x480: 240x320, 120x160, 60x80 template grids) and at the port
tests' (120x160: 60x80, 30x40, 15x20): every pixel in exactly one band, the
shared memory within a block's 232,448 bytes, C one of 1, 2, 4, 8, 16 and
never more than the rows; and that the plain evaluation's sums, taken band
by band and added in rank order as the kernel adds them, equal the
whole-level sums within 1e-6 relative (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.ops.cuda import level_solver as tlevel
from dense_visual_odometry_torch.ops.shiftwarp import residual_displacements, tent_sample

from tests.test_torch_kernels import _frozen

MAIN_GRIDS = [(240, 320), (120, 160), (60, 80)]
TEST_GRIDS = [(30, 40), (15, 20)]
H100_SMS = 132


@pytest.mark.parametrize("batch", [1, 8, 64, 200])
@pytest.mark.parametrize("grid", MAIN_GRIDS + TEST_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_bands_cover_every_pixel_once(grid, batch):
    hp, wp = grid
    geo = tlevel.level_geometry(batch, hp, wp, H100_SMS)
    assert geo.cluster in tlevel.CLUSTER_SIZES
    assert geo.cluster <= hp
    assert geo.shared_bytes <= tlevel.SHARED_LIMIT
    owner = np.full((hp, wp), -1)
    for rank, (r0, r1) in enumerate(tlevel.band_rows(hp, geo.cluster)):
        assert r1 > r0
        assert (r1 - r0) * wp <= geo.band_pixels <= geo.band_stride
        assert (owner[r0:r1] == -1).all()
        owner[r0:r1] = rank
    assert (owner >= 0).all()
    planes = tlevel.RESIDENT_PLANES if geo.resident else 1
    assert geo.shared_bytes == tlevel.STATIC_SHARED_BYTES + 4 * planes * geo.band_stride
    assert geo.band_stride % 4 == 0  # 16-byte aligned planes


@pytest.mark.parametrize(
    "cluster, layout",
    [
        (1, None),                        # 76,800 residuals: 307 KB, no room
        (2, (38400, 38400, False, 161792)),
        (8, (9600, 9600, False, 46592)),  # 11 planes would take 422 KB
        (16, (4800, 4800, True, 219392)),
    ],
)
def test_level0_layouts(cluster, layout):
    """The shared-memory layout of each cluster size at 640x480's level 0."""
    assert tlevel._layout(240, 320, cluster) == layout


@pytest.mark.parametrize(
    "batch, grid, cluster, resident",
    [
        (1, (240, 320), 16, True),   # 4,800 pixels per CTA, inputs on chip
        (8, (240, 320), 16, True),
        (64, (240, 320), 2, False),  # 38,400 pixels per CTA: residuals only
        (8, (120, 160), 16, True),
        (64, (120, 160), 2, False),
        (8, (60, 80), 8, True),      # at least one pixel per thread
        (64, (60, 80), 2, True),
        (1, (15, 20), 1, True),
    ],
)
def test_main_path_geometries(batch, grid, cluster, resident):
    geo = tlevel.level_geometry(batch, *grid, H100_SMS)
    assert (geo.cluster, geo.resident) == (cluster, resident)
    if grid == (240, 320) and cluster == 16:
        assert geo.band_pixels == 4800


def test_geometry_follows_what_the_card_schedules():
    asked = []

    def held(c, resident, dynamic_bytes):
        asked.append((c, resident, dynamic_bytes))
        return {16: 7, 8: 0}.get(c, 66)

    # Seven 16-CTA clusters at once: B=8 still takes 16 (two waves).
    geo = tlevel.level_geometry(8, 240, 320, H100_SMS, held)
    assert (geo.cluster, geo.max_active_clusters, geo.resident) == (16, 7, True)
    assert asked == [(16, True, 4 * tlevel.RESIDENT_PLANES * 4800)]
    # A size the card cannot schedule is passed over for the next one down.
    geo = tlevel.level_geometry(8, 240, 320, H100_SMS, lambda c, *a: 0 if c > 4 else 30)
    assert (geo.cluster, geo.max_active_clusters) == (4, 30)
    with pytest.raises(RuntimeError, match="schedules no cluster"):
        tlevel.level_geometry(8, 240, 320, H100_SMS, lambda *a: 0)


def test_geometry_refuses_a_band_that_never_fits():
    with pytest.raises(ValueError, match="does not fit"):
        tlevel.level_geometry(1, 4000, 4000, H100_SMS)


def _band_sum(cluster):
    """Sums over the pixels taken per CTA band, added in rank order."""

    def total(x):
        parts = [x[..., r0:r1, :].sum(dim=(-2, -1))
                 for r0, r1 in tlevel.band_rows(x.shape[-2], cluster)]
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    return total


@pytest.mark.parametrize("illum", [None, "bias", "affine"], ids=["no_illum", "bias", "affine"])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
def test_band_sums_equal_level_sums(stride, illum):
    cfg, fl, k, est0, image_hw = _frozen(stride)
    r = cfg.shift_stack_radius
    du, dv, valid = residual_displacements(fl.u0, fl.v0, fl.cu, fl.cv, r, stride, *image_hw)
    valid = valid & fl.valid_geom0
    acc = tent_sample(fl.planes, du, dv, r, stride)
    res = torch.where(valid, acc - fl.gray_prev, torch.zeros_like(acc))
    args = (res, valid, fl.gray_prev, fl.jac_planes, torch.tensor([0.04, 0.02]), 5.0, 3,
            True, True, illum == "bias", illum == "affine")
    whole = tlevel._reduce(*args)
    hp = res.shape[-2]
    for cluster in (c for c in tlevel.CLUSTER_SIZES if 1 < c <= hp):
        banded = tlevel._reduce(*args, total=_band_sum(cluster))
        for w, bnd in zip(whole, banded):
            w = torch.stack(w) if isinstance(w, tuple) else w
            bnd = torch.stack(bnd) if isinstance(bnd, tuple) else bnd
            scale = w.abs().max()
            assert float((bnd - w).abs().max()) <= 1e-6 * float(scale)
