"""Why some iteration counts part from the JAX package's: the loops decide at
the float32 quantum of the error, and the two packages' sums round apart.

Where a level stops on an absolute tolerance alone (the LM loop off the
level kernel without a relative tolerance, as at level 3 of the accurate
tiers; every Gauss-Newton level), the port's per-level iteration counts
part from the JAX package's by a few (the tests of ``track_pair`` hold the
measured gaps).  This file pins the cause on the seeded 120x160 scene of
``test_torch_track.py``, at one level-start pose per loop:

- the port's first evaluation and the JAX package's, on the same inputs at
  the same pose, agree in their valid counts and differ in the error by a
  few float32 ulps (the float32 sums add in another order);
- the port's loop, fed the JAX package's evaluation instead of its own,
  stops after exactly as many iterations as the JAX package's level solve,
  at a transform within 1e-6: the port's stopping logic is the JAX
  package's, and only the evaluations' last bits part.

Cases (measured here: the port's own evaluation stops after 28 and 12
iterations):

- ``lm_packed``: ``tpu_accurate``, the easy batch (pairs (0, 1), (6, 7)),
  level 3 from the identity: the "packed" evaluation in the LM loop.  The
  JAX package stops after 26; the JAX package's own ``_lm_loop`` fed the
  same evaluation does too, so that evaluation is the one its solve runs.
- ``gn_plain``: ``reference_default``, the easy batch, level 1 from the
  pose the JAX package's levels 3 and 2 reach: the "plain" evaluation with
  exact gradients in the Gauss-Newton loop.  The JAX package stops after 15.

The JAX evaluation is composed of the JAX package's public functions, as
its ``_solve_level`` composes them for these modes.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.models import robust as trobust
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.models import robust as jrobust
from dense_visual_odometry_tpu.models.weighting import t_distribution_weights_with_scale
from dense_visual_odometry_tpu.ops import gradients as jgrad
from dense_visual_odometry_tpu.ops import interp as jinterp
from dense_visual_odometry_tpu.ops import residuals as jres
from tests.test_torch_track import _batch, scene, tier_configs  # noqa: F401

CASES = {"lm_packed": ("tpu_accurate", "easy", 3), "gn_plain": ("reference_default", "easy", 1)}
MAX_ERROR_ULPS = 64  # measured at most 4 (lm_packed) and 49 (gn_plain, 2,815 pixels)


def level_arrays(scene, batch, level):  # noqa: F811
    prev, curr = _batch(scene, batch)
    return (
        np.stack([f.gray[level] for f in prev]),
        np.stack([f.depth_m[level] for f in prev]),
        np.stack([f.gray[level] for f in curr]),
        np.asarray(JCamera.create(scene["k"], 1.0).at(level)),
    )


def jax_evaluation(jcfg, mode, level, gray_prev, depth_prev, gray_curr, k):
    """The JAX package's evaluation of ``mode`` at ``level`` (no
    illumination, no prior), jitted: (estimate, lambda) -> (H, b, err,
    count, H, lambda)."""
    stride = jcfg.stride_for_level(level)
    sgain = 1.0 if jcfg.raw_sobel_gain else 8.0
    pre_jac = grads = None
    if jcfg.approximate_image2_gradient:
        gx1, gy1 = jgrad.sobel(jnp.asarray(gray_prev))
        pre_jac = jres.approximate_jacobian(gray_prev, depth_prev, k, gx1 / sgain, gy1 / sgain)
        pre_jac = pre_jac[..., ::stride, ::stride, :]
    else:
        gx2, gy2 = jgrad.sobel(jnp.asarray(gray_curr))
        grads = (gx2 / sgain, gy2 / sgain)
    gp, dp = gray_prev[..., ::stride, ::stride], depth_prev[..., ::stride, ::stride]

    @jax.jit
    def evaluate(estimate, weight_lambda):
        if mode == "packed":
            res, jac, valid = jres.warp_residuals_packed(
                gp, dp, jinterp.pack_neighbors(gray_curr), k, estimate,
                precomputed_jacobian=pre_jac, grid_stride=stride,
            )
        else:
            res, jac, valid = jres.warp_residuals(
                gp, dp, gray_curr, k, estimate, grads[0], grads[1], grid_stride=stride
            )
        weights, weight_lambda = t_distribution_weights_with_scale(
            res * res, valid, jcfg.weighter, event_ndim=2,
            init_lambda=weight_lambda if jcfg.weighter.warm_start else None,
        )
        sys = jres.normal_equations(res, jac, weights, valid)
        return sys.hessian, sys.rhs, sys.error, sys.count, sys.hessian, weight_lambda

    return evaluate


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 steps between same-signed finite values."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("case", list(CASES))
def test_port_loop_on_jax_evaluations_stops_as_jax(scene, case):  # noqa: F811
    name, batch, level = CASES[case]
    jcfg, tcfg = tier_configs(name)
    arrays = level_arrays(scene, batch, level)
    b = arrays[0].shape[0]
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy()
    start = eye
    for lv in range(jcfg.levels - 1, level, -1):  # the JAX package's coarser levels
        start = np.asarray(jax.jit(partial(jrobust._solve_level, cfg=jcfg, level=lv))(
            *level_arrays(scene, batch, lv), start, eye)[0])
    j_est, j_diag, _ = jax.jit(partial(jrobust._solve_level, cfg=jcfg, level=level))(
        *arrays, start, eye)
    j_its = int(j_diag.iterations)

    # The port's level solve, keeping the evaluation it hands its loop.
    loop = trobust._lm_loop if tcfg.lm_lambda0 is not None else trobust._gn_loop
    evaluations = []

    def spy(evaluate, *a, **kw):
        evaluations.append(evaluate)
        return loop(evaluate, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trobust, loop.__name__, spy)
        trobust._solve_level(*(torch.tensor(x) for x in arrays), torch.tensor(start),
                             torch.tensor(eye), tcfg, level=level)
    port_evaluate = evaluations[0]
    mode = trobust.level_plan(tcfg, level).default_mode
    j_evaluate = jax_evaluation(jcfg, mode, level, *arrays)

    def jax_evaluate(estimate, _anchor, weight_lambda):
        out = j_evaluate(estimate.numpy(), weight_lambda.numpy())
        return tuple(torch.tensor(np.asarray(x)) for x in out)

    # The first evaluation: equal counts, errors a few ulps apart.
    wlam0 = torch.full((b,), 1.0 / tcfg.weighter.initial_sigma**2)
    mine = port_evaluate(torch.tensor(start), torch.tensor(eye), wlam0)
    theirs = jax_evaluate(torch.tensor(start), None, wlam0)
    np.testing.assert_array_equal(mine[3].numpy(), theirs[3].numpy())
    assert ulps(mine[2].numpy(), theirs[2].numpy()).max() <= MAX_ERROR_ULPS
    np.testing.assert_allclose(mine[0].numpy(), theirs[0].numpy(), rtol=1e-5,
                               atol=1e-5 * np.abs(theirs[0].numpy()).max())

    # The port's loop on the JAX evaluations stops where the JAX package does.
    est, _, _, diag = loop(jax_evaluate, torch.tensor(start), torch.tensor(eye), tcfg, None,
                           tcfg.max_iterations_for_level(level))
    assert int(diag.iterations) == j_its
    np.testing.assert_allclose(est.numpy(), np.asarray(j_est), atol=1e-6)
    if loop is trobust._lm_loop:
        # The JAX package's own LM loop on the same evaluations: the same
        # count, so they are the evaluations its level solve runs.
        j_loop = jax.jit(lambda e: jrobust._lm_loop(
            lambda est, _anchor, wl: j_evaluate(est, wl), e, e, jcfg, (b,),
            max_iterations=jcfg.max_iterations_for_level(level)))
        assert int(j_loop(start)[3].iterations) == j_its
