"""``track_pair`` of the port against the JAX package on ``configs/tpu_accurate.json``
and ``configs/tpu_accurate_illum.json``.

Both tiers put levels 0-2 on the shift stack and level 3 off it: there the
"packed" evaluation runs in the LM loop.  The scene, batches and tolerances
are those of ``test_torch_track.py``: in the easy batch levels 0-2 are
solved by the level kernel's plain version (the level-0 Hessian one fused
evaluation) and level 3 by the packed LM loop; in the hard batch the
three-frame pair trips the hard-motion trigger (the whole batch evaluates
on the gather path with exact gradients at that level) and the noisy pair
is retracked with the fallback forced at every level.

:class:`Routes` records, for each cascade and level, which loop ran and
which evaluation modes it used; the variant files
(``test_torch_track_{lm,shift,esm_ladder}_variants.py``) use it too.
"""

import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.models import robust as trobust
from dense_visual_odometry_torch.parallel import batched_track_pair, stack_frame_data
from tests.test_torch_track import (  # noqa: F401  (scene is a fixture)
    ATOL,
    BATCHES,
    _batch,
    jax_track,
    scene,
    tier_configs,
)

# Loops and evaluations, by the name the tracker calls them under.
_LABELS = {
    "solve_level_fused": "kernel", "_lm_loop": "lm", "_gn_loop": "gn",
    "fused_shift_iteration": "fused", "warp_residuals_shift": "shift",
    "warp_residuals": "plain",
}


class Routes:
    """Spies on the tracker: ``log[(retrack, level)]`` is the set of loops
    and evaluation modes that level ran in the first cascade (``retrack``
    False) or the retrack.  The gather evaluation is "packed" with the
    template's Jacobian and "packed_exact" with the current image's exact
    gradients (the hard-motion fallback's mode when the level's Jacobian is
    the template's)."""

    def __init__(self, monkeypatch):
        self.log = {}
        self.current = None
        self.ladder_scores = 0
        solve_level = trobust._solve_level

        def spy_solve_level(*a, level=0, force_hard=None, **kw):
            self.current = (force_hard is not None, level)
            self.log.setdefault(self.current, set())
            return solve_level(*a, level=level, force_hard=force_hard, **kw)

        monkeypatch.setattr(trobust, "_solve_level", spy_solve_level)
        for name, label in _LABELS.items():
            monkeypatch.setattr(trobust, name, self._spy(getattr(trobust, name), label))
        packed = trobust.warp_residuals_packed

        def spy_packed(*a, precomputed_jacobian=None, **kw):
            self.log[self.current].add(
                "packed" if precomputed_jacobian is not None else "packed_exact"
            )
            return packed(*a, precomputed_jacobian=precomputed_jacobian, **kw)

        monkeypatch.setattr(trobust, "warp_residuals_packed", spy_packed)
        score = trobust._initial_photometric_error

        def spy_score(*a, **kw):
            self.ladder_scores += 1
            return score(*a, **kw)

        monkeypatch.setattr(trobust, "_initial_photometric_error", spy_score)

    def _spy(self, fn, label):
        def spy(*a, **kw):
            if self.current is not None:
                self.log[self.current].add(label)
            return fn(*a, **kw)

        return spy

    def cascade(self, retrack=False) -> dict:
        """{level: set of labels} of one cascade."""
        return {lv: names for (r, lv), names in self.log.items() if r == retrack}

    @property
    def retracked(self) -> bool:
        return any(r for r, _ in self.log)


def check_track(scene, tcfg, ref, batch, monkeypatch, init_guess=None,  # noqa: F811
                iter_slack=0, hessian_rtol=1e-4):
    """Track ``batch`` with the port on the CPU; hold it against ``ref`` (the
    JAX package's result) and, for the noise-free pairs, the truth.
    Per-level iteration counts may differ by ``iter_slack``; the level-0
    Hessians agree to ``hessian_rtol`` of their largest entry.  -> the
    :class:`Routes` it took."""
    routes = Routes(monkeypatch)
    prev, curr = _batch(scene, batch)
    tprev = stack_frame_data([trobust.frame_data_from_numpy(f, "cpu") for f in prev])
    tcurr = stack_frame_data([trobust.frame_data_from_numpy(f, "cpu") for f in curr])
    res = batched_track_pair(
        tprev, tcurr, torch.tensor(scene["k"]), tcfg,
        init_guess=None if init_guess is None else torch.tensor(init_guess),
    )
    its = res.diagnostics.iterations.numpy().astype(int)
    ref_its = np.asarray(ref.diagnostics.iterations).astype(int)
    assert np.abs(its - ref_its).max() <= iter_slack, (its, ref_its)
    np.testing.assert_allclose(res.transform.numpy(), ref.transform, atol=ATOL)
    np.testing.assert_array_equal(res.success.numpy(), ref.success)
    assert res.success.all()
    np.testing.assert_allclose(res.diagnostics.count.numpy(), ref.diagnostics.count)
    np.testing.assert_allclose(res.diagnostics.scale.numpy(), ref.diagnostics.scale, rtol=1e-4)
    np.testing.assert_allclose(res.diagnostics.error.numpy(), ref.diagnostics.error, rtol=1e-4)
    np.testing.assert_allclose(
        res.hessian.numpy(), ref.hessian, rtol=hessian_rtol,
        atol=hessian_rtol * np.abs(ref.hessian).max(),
    )
    for n, (i, j) in enumerate(BATCHES[batch]):
        if batch == "hard" and n == 0:
            continue
        gt = np.linalg.inv(scene["poses"][j]) @ scene["poses"][i]
        assert np.abs(res.transform[n].numpy() - gt).max() < 5e-3
    return routes


# Where a level stops on an absolute tolerance alone (the LM loop off the
# level kernel without a relative tolerance, as at level 3 of the accurate
# tiers, or the Gauss-Newton loop), its last decisions compare errors that
# differ by less than float32 resolves at that error: the two packages sum
# in different orders, their sums part in the last bits (already at the
# first evaluation of a level, at the same pose), and a trial accepted on
# one side is rejected on the other.  ``test_torch_stopping_quantum.py``
# pins this: fed the JAX package's evaluations, the port's loops stop where
# the JAX package's do.  The transforms stay within 1e-5.  Each test holds
# the per-level iteration counts to the largest gap measured on its batch,
# named below with the levels where the counts part; every other test holds
# them equal.  Batches: "easy" = pairs (0, 1) and (6, 7); "hard" = (0, 1)
# with the noisy frame and (1, 4).
ITER_GAPS = {
    ("tpu_accurate", "easy"): 2,  # level 3: 28 iterations against 26; level 2: 22 against 23
    ("tpu_accurate_illum", "hard"): 2,  # level 1 (gather loop): 38 against 36; level 3: 32 / 33
}

# The easy batch's routes under both accurate tiers.
ACCURATE_EASY = {3: {"lm", "packed"}, 2: {"kernel"}, 1: {"kernel"}, 0: {"kernel", "fused"}}


def check_accurate_hard(routes):
    """The hard batch: the trigger fires at some level of the first cascade
    (the gather loop with exact gradients), and the retrack runs the gather
    loop at every level."""
    first = routes.cascade()
    assert any({"lm", "packed_exact"} <= names for names in first.values()), first
    assert routes.retracked
    assert all({"lm", "packed_exact"} <= names for names in routes.cascade(True).values())


@pytest.fixture(scope="module", params=["tpu_accurate", "tpu_accurate_illum"])
def accurate_tier(request, scene):  # noqa: F811
    jcfg, tcfg = tier_configs(request.param)
    return request.param, tcfg, jax_track(scene, jcfg)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_track_pair_matches_jax(scene, accurate_tier, batch, monkeypatch):  # noqa: F811
    name, tcfg, ref = accurate_tier
    assert trobust.level_plan(tcfg, 3).default_mode == "packed"
    assert all(trobust.level_plan(tcfg, lv).level_kernel for lv in (0, 1, 2))
    routes = check_track(scene, tcfg, ref[batch], batch, monkeypatch,
                         iter_slack=ITER_GAPS.get((name, batch), 0))
    if batch == "easy":
        assert routes.cascade() == ACCURATE_EASY and not routes.retracked
    else:
        check_accurate_hard(routes)
