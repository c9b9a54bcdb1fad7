"""``track_pair`` at grid strides 3 and 4 with ESM gradients and with tiles.

- ``esm_stride4``: the parity tier with ESM gradients at (4, 2, 1, 1), whose
  ESM levels sample their frozen windows through the stack kernel's plain
  version at stride 4, against the JAX package with the checks of
  ``test_torch_track_strides.py`` (a file of its own so that its JAX
  compile runs on another test worker).
- ``tiles_stride3``: ``tpu_fast`` with 8 x 10 tiles at (3, 2, 1, 1).  The
  JAX package refuses tiles (and row blocks) at a stride above 2: at such a
  level its level-0 Hessian evaluates a window recentred at one centre
  through its ``prepare_shift_stack``, whose only check on the stride is
  ``grid_stride not in (1, 2)`` (the functions it calls, and its Pallas
  stack, fused and level kernels, take any stride: ``test_torch_strides.py``
  holds them against the port at strides 3 and 4).  The reference here is
  the JAX package's own tracker with that one check lifted inside this
  test (``_prepare_any_stride``, the function's body without it; the
  package's files stay as they are), with the checks of
  ``test_torch_track_strides.py``; every level of the easy batch runs on
  the level kernel's tiles, level 0 at stride 3.  The unpatched JAX
  package is shown to raise on the same configuration.
"""

import jax
import jax.numpy as jnp
import pytest

from dense_visual_odometry_torch.ops.cuda import level_solver as tlevel
from dense_visual_odometry_torch.ops.cuda import stackwarp as tstack
from dense_visual_odometry_tpu.models import robust as jrobust
from dense_visual_odometry_tpu.ops.pallas import fused_iter as jfused
from dense_visual_odometry_tpu.ops.pallas import stackwarp as jstackwarp
from tests.test_torch_track import BATCHES, _batch, scene, tier_configs  # noqa: F401
from tests.test_torch_track_strides import VARIANTS, check_stride_variant, stride_variant


@pytest.fixture(scope="module")
def esm_variant(scene):  # noqa: F811
    return stride_variant("esm_stride4", scene)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_esm_stride4_matches_jax(scene, esm_variant, batch, monkeypatch):  # noqa: F811
    strides = []
    stack_accumulate = tstack.stack_accumulate

    def spy_stack(*a, **kw):
        strides.append(a[4] if len(a) > 4 else kw["grid_stride"])
        return stack_accumulate(*a, **kw)

    monkeypatch.setattr(tstack, "stack_accumulate", spy_stack)
    check_stride_variant(scene, esm_variant, batch, monkeypatch)
    if batch == "easy":
        assert 4 in strides  # the ESM gradients of level 0, at stride 4


def _prepare_any_stride(image, u, v, radius=3, grid_stride=1, coord_mask=None):
    """The JAX package's ``stackwarp.prepare_shift_stack`` without its
    ``grid_stride not in (1, 2)`` check."""
    if radius < 1:
        raise ValueError("radius must be >= 1")
    h, w = image.shape[-2], image.shape[-1]
    hp, wp = u.shape[-2], u.shape[-1]
    cu, cv = jstackwarp.compute_recenter(u, v, radius, grid_stride, coord_mask)
    du, dv, valid = jstackwarp.residual_displacements(u, v, cu, cv, radius, grid_stride, h, w)
    planes = jstackwarp.extract_parity_planes(image, cu, cv, hp, wp, radius, grid_stride)
    return planes, du, dv, valid


@pytest.fixture(scope="module")
def tiles_variant(scene):  # noqa: F811
    """The port's configuration and the JAX package's results with
    ``_prepare_any_stride`` in place of its ``prepare_shift_stack``."""
    jcfg, _ = tier_configs(*VARIANTS["tiles_stride3"][:1], **VARIANTS["tiles_stride3"][1])
    prev, curr = _batch(scene, "easy")
    stack = lambda fs: jax.tree.map(lambda *x: jnp.stack(x), *fs)  # noqa: E731
    with pytest.raises(ValueError, match="grid_stride must be 1 or 2"):
        jrobust.track_pair(stack(prev), stack(curr), jrobust.CameraModel(
            intrinsics=jnp.asarray(scene["k"]), depth_scale=1.0), jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstackwarp, "prepare_shift_stack", _prepare_any_stride)
        mp.setattr(jfused, "prepare_shift_stack", _prepare_any_stride)
        return stride_variant("tiles_stride3", scene)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_tiles_stride3_tracks(scene, tiles_variant, batch, monkeypatch):  # noqa: F811
    layouts = []
    lm_level = tlevel.lm_level

    def spy_lm_level(*a, **kw):
        layouts.append((kw["grid_stride"], kw.get("n_blocks_x", 1)))
        return lm_level(*a, **kw)

    monkeypatch.setattr(tlevel, "lm_level", spy_lm_level)
    check_stride_variant(scene, tiles_variant, batch, monkeypatch)
    if batch == "easy":
        assert layouts == [(1, 10), (1, 10), (2, 10), (3, 10)]
