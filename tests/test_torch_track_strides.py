"""``track_pair`` at grid strides 3 and 4, the port against the JAX package.

The variants ``chip_smoke.VARIANTS`` runs on the card, on the hard and easy
batches of ``test_torch_track.py`` (the same 120x160 scene and tolerances):
``fast_stride3`` and ``fast_stride4``, ``tpu_fast`` with ``grid_strides``
(3, 2, 1, 1) and (4, 2, 1, 1).  ``test_torch_track_strides_esm.py`` runs
``esm_stride4`` (the parity tier with ESM gradients at (4, 2, 1, 1)) and
``tiles_stride3`` (``tpu_fast`` with 8 x 10 tiles at (3, 2, 1, 1)), so that
the JAX compiles run on two test workers.

At level 0 a 120x160 image gives a 40x54 grid at stride 3 (ceil(160 / 3))
and 30x40 at stride 4.  On the easy batch every level is solved by the
level kernel's plain version and the level-0 Hessian by the fused
evaluation (the spy sees level 0's stride); the hard batch runs the
trigger, the gather loop and the retrack.  Transforms agree within 1e-5
and the per-level iteration counts are identical.  Against the truth the
hard batch's three-frame pair is held to 1 cm at stride 4 (7.6 mm measured
under ``fast_stride4``, 6.4 mm under ``esm_stride4``: the 30x40 level-0
grid resolves less; both packages alike), the others to 5 mm as in
``test_torch_track.py``.
"""

import pytest

from dense_visual_odometry_torch.ops.cuda import level_solver as tlevel
from tests.test_torch_track import BATCHES, jax_track, scene, tier_configs  # noqa: F401
from tests.test_torch_track_accurate import check_track

VARIANTS = {
    "fast_stride3": ("tpu_fast", {"grid_strides": [3, 2, 1, 1]}),
    "fast_stride4": ("tpu_fast", {"grid_strides": [4, 2, 1, 1]}),
    "esm_stride4": ("tpu_parity", {"use_esm_gradients": True, "esm_levels": [0, 1, 2],
                                   "esm_fallback_max_rotation": 0.25,
                                   "grid_strides": [4, 2, 1, 1]}),
    "tiles_stride3": ("tpu_fast", {"recenter_blocks": 8, "recenter_col_blocks": 10,
                                   "grid_strides": [3, 2, 1, 1]}),
}
# Against the truth (metres and rotation entries), where not 5e-3.
TRUTH_ATOL = {"fast_stride4": 1e-2, "esm_stride4": 1e-2}


def stride_variant(name, scene):  # noqa: F811
    """-> (name, the port's configuration, the JAX package's results)."""
    base, overrides = VARIANTS[name]
    jcfg, tcfg = tier_configs(base, **overrides)
    return name, tcfg, jax_track(scene, jcfg)


def check_stride_variant(scene, variant, batch, monkeypatch):  # noqa: F811
    """The port's track of ``batch`` against the JAX package's; on the easy
    batch every level on the level kernel, each at its stride."""
    name, tcfg, ref = variant
    strides = []
    lm_level = tlevel.lm_level

    def spy_lm_level(*a, **kw):
        strides.append(kw["grid_stride"])
        return lm_level(*a, **kw)

    monkeypatch.setattr(tlevel, "lm_level", spy_lm_level)
    routes = check_track(scene, tcfg, ref[batch], batch, monkeypatch,
                         truth_atol=TRUTH_ATOL.get(name, 5e-3))
    if batch == "easy":
        assert routes.cascade() == {lv: {"kernel"} for lv in (3, 2, 1)} | {0: {"kernel", "fused"}}
        assert strides == list(tcfg.grid_strides)[::-1]
    else:
        assert routes.retracked


@pytest.fixture(scope="module", params=["fast_stride3", "fast_stride4"])
def variant(request, scene):  # noqa: F811
    return stride_variant(request.param, scene)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_strides_match_jax(scene, variant, batch, monkeypatch):  # noqa: F811
    check_stride_variant(scene, variant, batch, monkeypatch)
