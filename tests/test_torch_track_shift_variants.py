"""``track_pair`` of the port against the JAX package on ``tpu_accurate`` with
the "shift" evaluation per LM iteration.

``configs/tpu_accurate.json`` read verbatim, then:

- ``use_fused_iteration: false``: levels 0-2 evaluate through the stack
  kernel's plain version ("shift") with the template's Jacobian;
- ``packed_sampling: true, approximate_image2_gradient: false``: exact
  gradients, "shift" at levels 0-2 with the packed gradient pair and
  "packed" at level 3.  The hard-motion trigger then looks only at the
  shift-ball coverage (no rotation or displacement term), and only levels
  0-2 can fall back.

The checks of ``test_torch_track_accurate.py``, with the iteration counts
held to the gaps measured in ``ITER_GAPS`` (see
``test_torch_track_accurate.ITER_GAPS``).  A file of its own so that its
two JAX compiles run on another test worker.
"""

import pytest

from tests.test_torch_track import BATCHES, jax_track, scene, tier_configs  # noqa: F401
from tests.test_torch_track_accurate import check_accurate_hard, check_track

VARIANTS = {
    "shift_per_iteration": {"use_fused_iteration": False},
    "exact_gradients": {"packed_sampling": True, "approximate_image2_gradient": False},
}
# Measured, per level (3 to 0), port against the JAX package.
ITER_GAPS = {
    ("shift_per_iteration", "easy"): 2,  # level 3: 28 against 26
    ("exact_gradients", "easy"): 3,  # [27, 27, 30, 33] against [29, 27, 32, 36]
    ("exact_gradients", "hard"): 2,  # level 1: 38 against 36
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request, scene):  # noqa: F811
    jcfg, tcfg = tier_configs("tpu_accurate", **VARIANTS[request.param])
    return request.param, tcfg, jax_track(scene, jcfg)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_track_pair_matches_jax(scene, variant, batch, monkeypatch):  # noqa: F811
    name, tcfg, ref = variant
    # Nearest-sampled exact gradients jump where a warp moves a sample across
    # a rounding boundary, so Hessians at poses 1e-6 apart part by up to
    # 7e-4 of their largest entry (measured).
    routes = check_track(scene, tcfg, ref[batch], batch, monkeypatch,
                         iter_slack=ITER_GAPS.get((name, batch), 0),
                         hessian_rtol=1e-4 if name == "shift_per_iteration" else 2e-3)
    first = routes.cascade()
    if name == "shift_per_iteration":
        if batch == "easy":
            shift = {"lm", "shift"}
            assert first == {3: {"lm", "packed"}, 2: shift, 1: shift, 0: shift}
        else:
            check_accurate_hard(routes)
        return
    # Exact gradients: level 3 evaluates "packed" with exact gradients and
    # never falls back; levels 0-2 evaluate "shift".  The trigger looks at
    # the shift-ball coverage alone, which the three-frame pair passes (with
    # the template's Jacobian its rotation trips it), so only the retrack,
    # forced, samples levels 0-2 through the gather.
    assert first == {3: {"lm", "packed_exact"}, 2: {"lm", "shift"}, 1: {"lm", "shift"},
                     0: {"lm", "shift"}}
    assert routes.retracked == (batch == "hard")
    if batch == "hard":
        assert all("packed_exact" in names for names in routes.cascade(True).values())
