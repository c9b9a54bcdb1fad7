"""``track_pair`` of the port against the JAX package on ``configs/tpu_parity.json``.

The checks of ``test_torch_track.py`` (same scene, same hard and easy
batches, same tolerances) on the reference-accuracy tier, whose exposure-bias
illumination rides both kernels.  A file of its own so that its JAX compile
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
def parity_tier(scene):  # noqa: F811
    jcfg, tcfg = tier_configs("tpu_parity")
    assert tcfg.illumination == "bias"
    return tcfg, jax_track(scene, jcfg)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_track_pair_matches_jax(scene, parity_tier, batch, monkeypatch):  # noqa: F811
    tcfg, ref = parity_tier
    check_track_pair(scene, tcfg, ref[batch], batch, monkeypatch)
