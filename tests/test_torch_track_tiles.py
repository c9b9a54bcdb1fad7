"""``track_pair`` with tiles, the port against the JAX package:
``parity_tiles_r2`` (the parity tier's accuracy-max variant) and
``tiles_depth`` (tiles with the depth term), with the checks of
``test_torch_track_blocks.py`` (a file of its own so that its two JAX
compiles run on another test worker).
"""

import pytest

from tests.test_torch_track import BATCHES, scene  # noqa: F401  (scene is a fixture)
from tests.test_torch_track_blocks import check_variant, jax_variant


@pytest.fixture(scope="module", params=["parity_tiles_r2", "tiles_depth"])
def variant(request, scene):  # noqa: F811
    return jax_variant(request.param, scene)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_tiles_match_jax(scene, variant, batch, monkeypatch):  # noqa: F811
    check_variant(scene, variant, batch, monkeypatch)
