"""``track_pair`` of the port against the JAX package on ``tpu_accurate`` with
ESM gradients on every level, and with the init-scale ladder.

``configs/tpu_accurate.json`` read verbatim, then:

- ``use_esm_gradients: true, esm_levels: [0, 1, 2, 3]``: levels 0-2 average
  the frozen window's warped gradient into the level kernel's planes (one
  pass of the stack kernel's plain version each); level 3, off the fused
  kernels, averages the current image's gradients sampled nearest at the
  level-start warp of the full-resolution grid into the template's;
- ``init_scale_ladder: [0.5, 1.5]``, tracked with an init guess (the
  ladder runs only when one is given): each pair's guess is the true motion
  of the pair before it (the first pair's own), and the candidates
  exp(a * log(guess)), a in {0, 0.5, 1, 1.5}, are scored at half the
  coarsest level.

The checks of ``test_torch_track_accurate.py``, with the iteration counts
equal but where ``ITER_GAPS`` names a measured gap (see
``test_torch_track_accurate.ITER_GAPS``).  A file of its own so that its
two JAX compiles run on another test worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dense_visual_odometry_tpu.models import robust as jrobust
from tests.test_torch_track import BATCHES, _batch, scene, tier_configs  # noqa: F401
from tests.test_torch_track_accurate import check_accurate_hard, check_track

VARIANTS = {
    "esm_all_levels": {"use_esm_gradients": True, "esm_levels": [0, 1, 2, 3]},
    "init_scale_ladder": {"init_scale_ladder": [0.5, 1.5]},
}
# Measured: level 2 (gather loop) of the hard batch, 32 iterations against 33.
ITER_GAPS = {("esm_all_levels", "hard"): 1}


def init_guesses(scene, batch):  # noqa: F811
    """The true motion of the pair before each pair (the first pair's own)."""
    out = []
    for i, _ in BATCHES[batch]:
        a = max(i - 1, 0)
        out.append(np.linalg.inv(scene["poses"][a + 1]) @ scene["poses"][a])
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request, scene):  # noqa: F811
    jcfg, tcfg = tier_configs("tpu_accurate", **VARIANTS[request.param])
    ladder = request.param == "init_scale_ladder"
    tracker = jrobust.make_tracker(jcfg)
    ref = {}
    for name in BATCHES:
        prev, curr = _batch(scene, name)
        stack = lambda fs: jax.tree.map(lambda *x: jnp.stack(x), *fs)  # noqa: E731
        guess = init_guesses(scene, name) if ladder else None
        ref[name] = jax.tree.map(
            np.asarray, tracker(stack(prev), stack(curr), scene["k"], guess)
        )
    return request.param, tcfg, ref


@pytest.mark.parametrize("batch", list(BATCHES))
def test_track_pair_matches_jax(scene, variant, batch, monkeypatch):  # noqa: F811
    name, tcfg, ref = variant
    guess = init_guesses(scene, batch) if name == "init_scale_ladder" else None
    routes = check_track(scene, tcfg, ref[batch], batch, monkeypatch, init_guess=guess,
                         iter_slack=ITER_GAPS.get((name, batch), 0))
    if name == "init_scale_ladder":
        assert routes.ladder_scores == 4  # a in {0, 0.5, 1, 1.5}
    if batch == "easy":
        assert routes.cascade() == {
            3: {"lm", "packed"}, 2: {"kernel"}, 1: {"kernel"}, 0: {"kernel", "fused"}
        }
    else:
        check_accurate_hard(routes)
