"""The launch geometry of the cluster kernels, on the CPU.

``level_geometry`` spreads each batch element of a level over a cluster of
C CTAs, CTA rank k on the template rows ``band_rows(hp, C)[k]``, for the
level kernel (``LEVEL_KERNEL``: residuals, points, template and Jacobian
in shared memory where they fit, 11 planes) and the fused kernel
(``fused_iter.FUSED_KERNEL``: the residuals alone, and one wave of
clusters where the card holds one).  These tests hold the rule to what
the kernels need at the main path's level shapes (640x480: 240x320,
120x160, 60x80 template grids) and at the port tests' (120x160: 60x80,
30x40, 15x20): every pixel in exactly one band, the shared memory within
a block's 232,448 bytes, C one of 1, 2, 4, 8, 16 and never more than the
rows; the layouts and choices at B=1, 8 and 64; where the inputs stop
fitting; what the card schedules; and that the plain evaluation's sums,
taken band by band and added in rank order as the kernel adds them, equal
the whole-level sums within 1e-6 relative (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.ops.cuda import fused_iter as tfused
from dense_visual_odometry_torch.ops.cuda import level_solver as tlevel
from dense_visual_odometry_torch.ops.shiftwarp import residual_displacements, tent_sample

from tests.test_torch_kernels import _frozen

MAIN_GRIDS = [(240, 320), (120, 160), (60, 80)]
TEST_GRIDS = [(30, 40), (15, 20)]
H100_SMS = 132
KERNELS = {"level": tlevel.LEVEL_KERNEL, "fused": tfused.FUSED_KERNEL}


def _h100(c, resident, dynamic_bytes):
    """Clusters an H100 holds at once, by size, as cudaOccupancyMaxActiveClusters
    reports them for both kernels at 640x480's level 0 (PERF.md)."""
    return {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}[c]


def _seven_of_16(c, resident, dynamic_bytes):
    return {16: 7, 8: 0}.get(c, 66)


def _none_above_4(c, resident, dynamic_bytes):
    return 0 if c > 4 else 30


def _none(c, resident, dynamic_bytes):
    return 0


@pytest.mark.parametrize("batch", [1, 8, 64, 200])
@pytest.mark.parametrize("grid", MAIN_GRIDS + TEST_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_bands_cover_every_pixel_once(kernel, grid, batch):
    hp, wp = grid
    geo = tlevel.level_geometry(batch, hp, wp, H100_SMS, kernel=KERNELS[kernel])
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
    planes = KERNELS[kernel].resident_planes if geo.resident else 1
    assert geo.shared_bytes == tlevel.STATIC_SHARED_BYTES + 4 * planes * geo.band_stride
    assert geo.band_stride % 4 == 0  # 16-byte aligned planes


@pytest.mark.parametrize(
    "kernel, cluster, layout",
    [
        ("level", 1, None),                        # 76,800 residuals: 307 KB, no room
        ("level", 2, (38400, 38400, False, 161792)),
        ("level", 4, (19200, 19200, False, 84992)),
        ("level", 8, (9600, 9600, False, 46592)),  # 11 planes would take 422 KB
        ("level", 16, (4800, 4800, True, 219392)),
        ("fused", 1, None),
        ("fused", 2, (38400, 38400, False, 161792)),
        ("fused", 4, (19200, 19200, False, 84992)),
        ("fused", 8, (9600, 9600, False, 46592)),
        ("fused", 16, (4800, 4800, False, 27392)),  # the residuals alone
    ],
)
def test_level0_layouts(kernel, cluster, layout):
    """The shared-memory layout of each cluster size at 640x480's level 0."""
    assert tlevel._layout(240, 320, cluster, KERNELS[kernel].resident_planes) == layout


@pytest.mark.parametrize(
    "kernel, batch, grid, cluster, resident",
    [
        ("level", 1, (240, 320), 16, True),   # 4,800 pixels per CTA, inputs on chip
        ("level", 8, (240, 320), 16, True),   # two waves of 7 clusters
        ("level", 64, (240, 320), 2, False),  # 38,400 pixels per CTA: residuals only
        ("level", 8, (120, 160), 16, True),
        ("level", 64, (120, 160), 2, False),
        ("level", 8, (60, 80), 8, True),      # at least one pixel per thread
        ("level", 64, (60, 80), 2, True),
        ("level", 1, (15, 20), 1, True),
        ("fused", 1, (240, 320), 16, False),  # the session
        ("fused", 8, (240, 320), 8, False),   # 7 clusters of 16 at once: 8 in one wave
        ("fused", 64, (240, 320), 2, False),
        ("fused", 1, (60, 80), 8, False),     # at least one pixel per thread
        ("fused", 8, (60, 80), 8, False),
        ("fused", 64, (60, 80), 2, False),
        ("fused", 2, (30, 40), 2, False),     # the CPU tests' grid
    ],
)
def test_main_path_geometries(kernel, batch, grid, cluster, resident):
    """On an H100's schedule; a one-wave kernel holds the batch at once."""
    geo = tlevel.level_geometry(batch, *grid, H100_SMS, _h100, KERNELS[kernel])
    assert (geo.cluster, geo.resident) == (cluster, resident)
    assert geo.max_active_clusters >= batch or not KERNELS[kernel].one_wave
    if grid == (240, 320) and cluster == 16:
        assert geo.band_pixels == 4800


@pytest.mark.parametrize(
    "kernel, wp, resident",
    [
        ("level", 5096, True),    # 5,096 x 44 B + 8,192 fits the 11 planes
        ("level", 5100, False),
        ("level", 56064, False),  # 56,064 x 4 B + 8,192 = 232,448 bytes: the last that fits
        ("level", 56068, None),
        ("fused", 5096, False),   # the residuals alone, at any size
        ("fused", 56064, False),
        ("fused", 56068, None),
    ],
)
def test_resident_switch(kernel, wp, resident):
    """Where a band's inputs stop fitting beside its residuals (one row of
    ``wp`` pixels on one CTA), and where the residuals stop fitting."""
    layout = tlevel._layout(1, wp, 1, KERNELS[kernel].resident_planes)
    assert (None if layout is None else layout[2]) is resident


@pytest.mark.parametrize(
    "kernel, batch, held, expected",
    [
        ("level", 8, _seven_of_16, (16, 7, True)),  # B=8 still takes 16: two waves
        ("fused", 7, _seven_of_16, (16, 7, False)),  # seven 16-CTA clusters: one wave
        ("fused", 8, _seven_of_16, (4, 66, False)),  # 8-CTA clusters unscheduled here
        ("fused", 100, _seven_of_16, (2, 66, False)),  # none holds 100: the largest scheduled
        ("level", 8, _none_above_4, (4, 30, False)),  # the next size down
        ("fused", 8, _none_above_4, (4, 30, False)),
        ("level", 8, _none, None),
        ("fused", 8, _none, None),
    ],
    ids=lambda v: getattr(v, "__name__", None),
)
def test_geometry_follows_what_the_card_schedules(kernel, batch, held, expected):
    asked = []

    def ask(c, resident, dynamic_bytes):
        asked.append((c, resident, dynamic_bytes))
        return held(c, resident, dynamic_bytes)

    planes = KERNELS[kernel].resident_planes
    if expected is None:
        with pytest.raises(RuntimeError, match="schedules no cluster"):
            tlevel.level_geometry(batch, 240, 320, H100_SMS, ask, KERNELS[kernel])
        return
    geo = tlevel.level_geometry(batch, 240, 320, H100_SMS, ask, KERNELS[kernel])
    assert (geo.cluster, geo.max_active_clusters, geo.resident) == expected
    for c, resident, dynamic_bytes in asked:
        _, _, fits, shared = tlevel._layout(240, 320, c, planes)
        assert (resident, dynamic_bytes) == (fits, shared - tlevel.STATIC_SHARED_BYTES)


@pytest.mark.parametrize("grid", [(4000, 4000), (1, 60000)], ids=["4000x4000", "1x60000"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_geometry_refuses_a_band_that_never_fits(kernel, grid):
    with pytest.raises(ValueError, match="does not fit"):
        tlevel.level_geometry(1, *grid, H100_SMS, kernel=KERNELS[kernel])


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_geometries_lists_every_fitting_layout(kernel):
    """``geometries``: each cluster size that fits 640x480's level 0, with
    the resident planes where they fit and with the residuals alone."""
    k = KERNELS[kernel]
    got = [(g.cluster, g.resident, g.shared_bytes) for g in tlevel.geometries(240, 320, k)]
    want = []
    for c in (2, 4, 8, 16):
        _, stride, resident, shared = tlevel._layout(240, 320, c, k.resident_planes)
        if resident:
            want.append((c, True, shared))
        want.append((c, False, tlevel.STATIC_SHARED_BYTES + 4 * stride))
    assert got == want
    assert [c for c, res, _ in got if res] == ([16] if kernel == "level" else [])


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
