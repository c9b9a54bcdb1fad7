"""``track_pair`` of the port against the JAX package on ``tpu_parity`` with
ESM gradients.

``configs/tpu_parity.json`` read verbatim, with ESM gradients on levels 0-2
and the relaxed rotation trigger there (``esm_fallback_max_rotation:
0.25``): each of those levels samples its frozen window once through the
stack kernel (its plain version on the CPU) and averages the warped image's
gradient into the Jacobian planes.  The checks of ``test_torch_track.py``:
same scene, same hard and easy batches, same tolerances.  Under the relaxed
trigger the hard batch's three-frame pair stays on the level kernel (with
ESM) in the first cascade; its noisy pair still forces the retrack onto the
gather loop.  A file of its own
so that its JAX compile runs on another test worker.
"""

import pytest

from tests.test_torch_track import (  # noqa: F401  (scene is a fixture)
    BATCHES,
    check_track_pair,
    jax_track,
    scene,
    tier_configs,
)

ESM = dict(use_esm_gradients=True, esm_levels=[0, 1, 2], esm_fallback_max_rotation=0.25)


@pytest.fixture(scope="module")
def parity_esm(scene):  # noqa: F811
    jcfg, tcfg = tier_configs("tpu_parity", **ESM)
    return tcfg, jax_track(scene, jcfg)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_track_pair_matches_jax(scene, parity_esm, batch, monkeypatch):  # noqa: F811
    tcfg, ref = parity_esm
    check_track_pair(scene, tcfg, ref[batch], batch, monkeypatch, stack_on_easy=True,
                     hard_trips_trigger=False)
