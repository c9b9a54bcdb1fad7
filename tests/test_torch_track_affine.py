"""``track_pair`` of the port against the JAX package on ``tpu_parity`` with
affine illumination.

``configs/tpu_parity.json`` read verbatim, with ``illumination: "affine"``:
the level kernel runs its rank-2 gain + bias Schur, the gather fallback
applies the affine pre-fit and ``_affine_schur``, and the level-0 Hessian
is the "shift" evaluation through the stack kernel (its plain version on
the CPU).  The checks of ``test_torch_track.py``: same scene, same hard and
easy batches, same tolerances.  A file of its own so that its JAX compile
runs on another test worker.
"""

import pytest

from tests.test_torch_track import (  # noqa: F401  (scene is a fixture)
    BATCHES,
    check_track_pair,
    jax_track,
    scene,
    tier_configs,
)


@pytest.fixture(scope="module")
def parity_affine(scene):  # noqa: F811
    jcfg, tcfg = tier_configs("tpu_parity", illumination="affine")
    return tcfg, jax_track(scene, jcfg)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_track_pair_matches_jax(scene, parity_affine, batch, monkeypatch):  # noqa: F811
    tcfg, ref = parity_affine
    check_track_pair(scene, tcfg, ref[batch], batch, monkeypatch, stack_on_easy=True)
