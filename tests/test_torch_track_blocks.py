"""``track_pair`` with row blocks, tiles and the anisotropic ball, the port
against the JAX package.

The variants users set (each a shipped configuration with overrides, as
``chip_smoke.VARIANTS`` runs them on the card), on the hard and easy batches
of ``test_torch_track.py`` (the same 120x160 scene and tolerances):

- ``fast_blocks_ry2``: ``tpu_fast`` with 6 row blocks and the vertical
  radius 2 (``benchmarks/exp_blocks.py:105``);
- ``parity_tiles_r2``: ``tpu_parity`` with 8 x 10 tiles at radius 2, the
  parity tier's accuracy-max variant (``benchmarks/RESULTS.md:1023``);
- ``slam_tiles_cb48``: ``tpu_slam`` with 8 x 10 tiles, the rotation trigger
  at 0.25 rad and the centre clip at 48 px (``benchmarks/exp_slampareto.py:140``);
- ``tiles_depth``: ``tpu_fast`` with 8 x 10 tiles and the depth term (the
  current depth's windows at the tiles' centres).

This file runs ``fast_blocks_ry2`` and ``slam_tiles_cb48``;
``test_torch_track_tiles.py`` the other two, so that the four JAX compiles
(about 80 s each here) run on two test workers.

On the easy batch every level is solved by the level kernel's plain
version on its blocks or tiles (the spy on ``lm_level`` sees the layout at
each level) and the level-0 Hessian by the fused evaluation, recentred at
the solution as the JAX package recentres it at such a level; the hard
batch runs the trigger on the blocks' or tiles' coverage, the gather loop
and the retrack.  Transforms agree within 1e-5 and the per-level iteration
counts are identical.

Then the JAX package's own block and tile solver cases
(``tests/unit/test_recenter_blocks.py:150-211``,
``tests/unit/test_recenter_tiles.py:107-185``) on the port: pure
translation solves as one centre does, an in-plane rotation is recovered,
and a pair without valid depth stays finite through the block and tile
trigger.
"""

import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel as TCamera
from dense_visual_odometry_torch.config import RobustDVOConfig as TConfig
from dense_visual_odometry_torch.config import TWeighterConfig
from dense_visual_odometry_torch.models import robust as trobust
from dense_visual_odometry_torch.ops import pyramid as tpyr
from dense_visual_odometry_torch.ops.cuda import level_solver as tlevel
from dense_visual_odometry_torch.utils.lie import se3
from tests.test_torch_track import BATCHES, jax_track, scene, tier_configs  # noqa: F401
from tests.test_torch_track_accurate import check_track

VARIANTS = {
    "fast_blocks_ry2": ("tpu_fast", {"recenter_blocks": 6, "shift_stack_radius_y": 2}),
    "parity_tiles_r2": ("tpu_parity", {"recenter_blocks": 8, "recenter_col_blocks": 10,
                                       "shift_stack_radius": 2}),
    "slam_tiles_cb48": ("tpu_slam", {"recenter_blocks": 8, "recenter_col_blocks": 10,
                                     "fallback_max_rotation": 0.25,
                                     "recenter_center_bound": 48}),
    "tiles_depth": ("tpu_fast", {"recenter_blocks": 8, "recenter_col_blocks": 10,
                                 "use_depth_residuals": True}),
}
# The depth term against the truth on this scene (test_torch_track_depth.py).
TRUTH_ATOL = {"tiles_depth": 2e-2}


def jax_variant(name, scene):  # noqa: F811
    """-> (name, the port's configuration, the JAX package's results)."""
    base, overrides = VARIANTS[name]
    jcfg, tcfg = tier_configs(base, **overrides)
    return name, tcfg, jax_track(scene, jcfg)


def check_variant(scene, variant, batch, monkeypatch):  # noqa: F811
    """The port's track of ``batch`` against the JAX package's, with every
    level-kernel solve on the variant's blocks or tiles."""
    name, tcfg, ref = variant
    layouts = []
    lm_level = tlevel.lm_level

    def spy_lm_level(*a, **kw):
        layouts.append((kw.get("n_blocks", 1), kw.get("n_blocks_x", 1), kw.get("radius_y")))
        return lm_level(*a, **kw)

    monkeypatch.setattr(tlevel, "lm_level", spy_lm_level)
    routes = check_track(scene, tcfg, ref[batch], batch, monkeypatch,
                         truth_atol=TRUTH_ATOL.get(name, 5e-3))
    overrides = VARIANTS[name][1]
    want = (overrides["recenter_blocks"], overrides.get("recenter_col_blocks", 1),
            overrides.get("shift_stack_radius_y", tcfg.shift_stack_radius))
    assert all(lay == want for lay in layouts), layouts
    if batch == "easy":
        assert routes.cascade() == {lv: {"kernel"} for lv in (3, 2, 1)} | {0: {"kernel", "fused"}}
        assert len(layouts) == tcfg.levels
    else:
        assert routes.retracked


@pytest.fixture(scope="module", params=["fast_blocks_ry2", "slam_tiles_cb48"])
def variant(request, scene):  # noqa: F811
    return jax_variant(request.param, scene)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_blocks_and_tiles_match_jax(scene, variant, batch, monkeypatch):  # noqa: F811
    check_variant(scene, variant, batch, monkeypatch)


# The JAX package's own solver cases (tests/unit/test_recenter_blocks.py).
H, W = 120, 160
K = np.array([[120.0, 0.0, (W - 1) / 2], [0.0, 120.0, (H - 1) / 2], [0.0, 0.0, 1.0]],
             dtype=np.float32)
Z0 = 2.0


def _texture(u, v):
    return (
        120.0
        + 50.0 * np.sin(2 * np.pi * u / 31.0)
        + 40.0 * np.cos(2 * np.pi * v / 23.0)
        + 25.0 * np.sin(2 * np.pi * (u + 2 * v) / 57.0)
        + 15.0 * np.cos(2 * np.pi * (3 * u - v) / 83.0)
    )


def _frame(gray, depth, levels=3):
    return trobust.FrameData(
        gray=tpyr.build_pyramid(torch.tensor(gray)[None], levels),
        depth_m=tpyr.build_pyramid(torch.tensor(depth)[None], levels),
    )


def _cfg(**overrides):
    base = dict(
        levels=3, max_iterations=12, use_weighter=True, packed_sampling=True,
        grid_strides=(2, 1, 1), weighter=TWeighterConfig(scale_subsample=4),
        shift_stack_radius=3, shift_stack_levels=(0, 1), approximate_image2_gradient=True,
        relative_tolerance=1e-2, lm_lambda0=1e-4, use_pallas_stack=True,
        use_fused_iteration=True, freeze_shift_window=True, use_level_kernel=True,
    )
    return TConfig(**{**base, **overrides})


def _grid():
    return np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                       indexing="ij")


def _rotated(angle):
    v, u = _grid()
    c = np.array([K[0, 2], K[1, 2]])
    ca, sa = np.cos(angle), np.sin(angle)
    du, dv = u - c[0], v - c[1]
    return (_texture(u, v).astype(np.float32),
            _texture(ca * du + sa * dv + c[0], -sa * du + ca * dv + c[1]).astype(np.float32))


@pytest.mark.parametrize("kind", ["blocks", "tiles", "blocks_ry2"])
def test_translation_solves_as_one_centre(kind):
    """Pure translation: every block's centre is the global one, so blocks,
    tiles and the smaller vertical radius solve as one centre does."""
    tx = 0.01
    v, u = _grid()
    gray1 = _texture(u, v).astype(np.float32)
    gray2 = _texture(u - K[0, 0] * tx / Z0, v).astype(np.float32)
    depth = np.full((H, W), Z0, dtype=np.float32)
    cam = TCamera.create(K, 1.0)
    blocks = {"blocks": dict(recenter_blocks=4), "tiles": dict(recenter_blocks=4,
                                                               recenter_col_blocks=4),
              "blocks_ry2": dict(recenter_blocks=4, shift_stack_radius_y=2)}[kind]
    results = {}
    for name, cfg in (("one", _cfg()), (kind, _cfg(**blocks))):
        r = trobust.track_pair(_frame(gray1, depth), _frame(gray2, depth), cam, cfg)
        assert bool(r.success[0])
        results[name] = r.transform[0].numpy()
    np.testing.assert_allclose(results[kind], results["one"], atol=1e-4)
    assert results[kind][0, 3] == pytest.approx(tx, abs=3e-3)


@pytest.mark.parametrize("kind, angle, blocks, tol", [
    ("blocks", 0.01, dict(recenter_blocks=4, max_iterations=30), 2e-3),
    # A 2.5 degree rotation, ~4.4 px at the corners: outside one radius-3
    # ball; the trigger relaxed so that the tiles solve it.
    ("tiles", 0.044, dict(recenter_blocks=6, recenter_col_blocks=6, max_iterations=30,
                          fallback_max_rotation=1.0), 3e-3),
], ids=["blocks", "tiles"])
def test_rotation_is_recovered(kind, angle, blocks, tol):
    gray1, gray2 = _rotated(angle)
    depth = np.full((H, W), Z0, dtype=np.float32)
    r = trobust.track_pair(_frame(gray1, depth), _frame(gray2, depth),
                           TCamera.create(K, 1.0), _cfg(**blocks))
    assert bool(r.success[0])
    xi = se3.log(r.transform)[0].numpy()
    assert xi[5] == pytest.approx(angle, abs=tol)


@pytest.mark.parametrize("blocks", [dict(recenter_blocks=4),
                                    dict(recenter_blocks=4, recenter_col_blocks=4)],
                         ids=["blocks", "tiles"])
def test_zero_depth_stays_finite(blocks):
    """The block and tile coverage trigger and the fallback keep a pair
    without valid depth finite."""
    v, u = _grid()
    gray = _texture(u, v).astype(np.float32)
    zero = np.zeros((H, W), np.float32)
    cfg = _cfg(shift_stack_fallback=True, **blocks)
    r = trobust.track_pair(_frame(gray, zero), _frame(gray, zero), TCamera.create(K, 1.0), cfg)
    assert torch.isfinite(r.transform).all()
