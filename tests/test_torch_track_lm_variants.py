"""``track_pair`` of the port against the JAX package on ``tpu_accurate`` with
the level kernel off: the "fused" evaluation per LM iteration.

``configs/tpu_accurate.json`` read verbatim, then:

- ``use_level_kernel: false``: levels 0-2 run the LM loop with one fused
  evaluation per iteration (the fused kernel's plain version) on the frozen
  window;
- also ``freeze_shift_window: false``: the window is recentred at every
  evaluated estimate and extracted again.

The checks of ``test_torch_track_accurate.py`` (same scene, batches and
tolerances; the LM loop stops on an absolute tolerance at every level, so
the iteration counts are held to the gaps measured in ``ITER_GAPS``, as
``test_torch_track_accurate.ITER_GAPS`` explains).  A file of its own so
that its two JAX compiles run on another test worker.
"""

import pytest

from tests.test_torch_track import BATCHES, jax_track, scene, tier_configs  # noqa: F401
from tests.test_torch_track_accurate import check_accurate_hard, check_track

VARIANTS = {
    "fused_per_iteration": {"use_level_kernel": False},
    "window_per_evaluation": {"use_level_kernel": False, "freeze_shift_window": False},
}
# Measured; both at level 3 of the easy batch: 28 iterations against 26.
ITER_GAPS = {("fused_per_iteration", "easy"): 2, ("window_per_evaluation", "easy"): 2}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request, scene):  # noqa: F811
    jcfg, tcfg = tier_configs("tpu_accurate", **VARIANTS[request.param])
    return request.param, tcfg, jax_track(scene, jcfg)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_track_pair_matches_jax(scene, variant, batch, monkeypatch):  # noqa: F811
    name, tcfg, ref = variant
    routes = check_track(scene, tcfg, ref[batch], batch, monkeypatch,
                         iter_slack=ITER_GAPS.get((name, batch), 0))
    if batch == "easy":
        fused_lm = {"lm", "fused"}
        assert routes.cascade() == {3: {"lm", "packed"}, 2: fused_lm, 1: fused_lm, 0: fused_lm}
    else:
        check_accurate_hard(routes)
