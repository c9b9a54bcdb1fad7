"""``track_pair`` of the port against the JAX package on ``configs/tpu_fast.json``.

Both packages read the shipped tier configs verbatim (this file
``tpu_fast``; ``test_torch_track_parity.py`` runs the same checks on
``tpu_parity``, ``test_torch_track_affine.py`` and ``test_torch_track_esm.py``
on ``tpu_parity`` with affine illumination and with ESM gradients, and
``test_torch_session.py`` the session, each file one JAX compile) and track
the same pyramids (the JAX package's, handed over as
numpy through ``frame_data_from_numpy``) of a seeded synthetic 120x160 scene:
B=2 per batch, the port on the CPU (plain versions of the kernels), the JAX
package with its Pallas kernels in interpret mode.

- Batch "hard": one pair's current frame carries heavy seeded sensor noise,
  so its finest-level IRLS scale ends above ``retrack_max_scale`` and the
  retrack runs; the other pair spans three frames of motion, so the
  hard-motion trigger fires for it and the batch-global fallback (the LM
  loop on the gather path) runs in the first cascade too.
- Batch "easy": two consecutive pairs; the level kernel solves every level.

The hard batch's noisy pair is checked against the other package only; the
noise-free pairs are also held against the rendered truth.

Transforms agree within 1e-5 and the per-level iteration counts are
identical.  The depth of a 16-pixel border band is invalid (as a Kinect's
border often is): the first solve of a frame starts at the identity, where a
template pixel on the image border projects exactly onto the bounds test's
edge and the last bit of its projection decides its validity; XLA:CPU fuses
multiply-adds there and PyTorch does not.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel as TCamera
from dense_visual_odometry_torch.config import RobustDVOConfig as TConfig
from dense_visual_odometry_torch.io import synthetic
from dense_visual_odometry_torch.models import robust as trobust
from dense_visual_odometry_torch.ops.cuda import stackwarp as tstack
from dense_visual_odometry_torch.parallel import batched_track_pair, stack_frame_data
from dense_visual_odometry_tpu.camera import CameraModel as JCamera
from dense_visual_odometry_tpu.config import RobustDVOConfig as JConfig
from dense_visual_odometry_tpu.models import robust as jrobust

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
H, W, BAND = 120, 160, 16
ATOL = 1e-5
BATCHES = {"hard": [(0, 1), (1, 4)], "easy": [(0, 1), (6, 7)]}
NOISY_FRAME, NOISE_SIGMA = 1, 25.0


@pytest.fixture(scope="module")
def scene():
    gray, depth, k = synthetic.textured_scene(H, W, seed=0)
    poses = synthetic.handheld_trajectory(8, seed=0)
    grays, depths = synthetic.render_sequence(gray, depth, k, poses)
    for d in depths:
        d[:BAND], d[-BAND:], d[:, :BAND], d[:, -BAND:] = 0, 0, 0, 0
    noise = np.random.default_rng(5).normal(0, NOISE_SIGMA, (H, W)).astype(np.float32)
    noisy = grays[NOISY_FRAME] + noise
    jcam = JCamera.create(k, 1.0)
    prep = jax.jit(lambda g, d: jrobust.preprocess_frame(g, d, jcam, levels=4))
    frames = [jax.tree.map(np.asarray, prep(g, d)) for g, d in zip(grays, depths)]
    noisy_frame = jax.tree.map(np.asarray, prep(noisy, depths[NOISY_FRAME]))
    return dict(k=k, grays=grays, depths=depths, poses=poses, frames=frames,
                noisy_frame=noisy_frame)


def _batch(scene, name):
    pairs = BATCHES[name]
    prev = [scene["frames"][i] for i, _ in pairs]
    curr = [
        scene["noisy_frame"] if (name == "hard" and n == 0) else scene["frames"][j]
        for n, (_, j) in enumerate(pairs)
    ]
    return prev, curr


def tier_configs(name: str, **overrides):
    """Both packages' configs of ``configs/<name>.json``, with ``overrides``."""
    data = {**json.loads((CONFIGS / f"{name}.json").read_text()), **overrides}
    return JConfig.from_dict(data), TConfig.from_dict(data)


def jax_track(scene, jcfg, last_transforms=None) -> dict:
    """The JAX package's results for both batches (one compile), with the
    prior's anchors ``last_transforms[batch]`` (B, 4, 4) where given."""
    tracker = jrobust.make_tracker(jcfg)
    out = {}
    for name in BATCHES:
        prev, curr = _batch(scene, name)
        stack = lambda fs: jax.tree.map(lambda *x: jnp.stack(x), *fs)  # noqa: E731
        last = None if last_transforms is None else jnp.asarray(last_transforms[name])
        out[name] = jax.tree.map(
            np.asarray, tracker(stack(prev), stack(curr), scene["k"], last_transform=last))
    return out


def check_track_pair(scene, tcfg, ref, batch, monkeypatch, stack_on_easy=False,
                     hard_trips_trigger=True):
    """Track ``batch`` with the port; hold it against ``ref`` and the truth.
    ``stack_on_easy``: whether the easy batch samples through the stack
    warp (ESM gradients or the "shift" evaluation); ``hard_trips_trigger``:
    whether the hard batch's three-frame pair trips the hard-motion trigger
    (else only the retrack runs the gather loop, at every level)."""
    calls = {"fallback": 0, "retrack": 0, "stack": 0}
    lm_loop, solve_level = trobust._lm_loop, trobust._solve_level
    stack_accumulate = tstack.stack_accumulate

    def spy_lm_loop(*a, **kw):
        calls["fallback"] += 1
        return lm_loop(*a, **kw)

    def spy_solve_level(*a, force_hard=None, **kw):
        calls["retrack"] += force_hard is not None
        return solve_level(*a, force_hard=force_hard, **kw)

    def spy_stack_accumulate(*a, **kw):
        calls["stack"] += 1
        return stack_accumulate(*a, **kw)

    monkeypatch.setattr(trobust, "_lm_loop", spy_lm_loop)
    monkeypatch.setattr(trobust, "_solve_level", spy_solve_level)
    monkeypatch.setattr(tstack, "stack_accumulate", spy_stack_accumulate)

    prev, curr = _batch(scene, batch)
    tprev = stack_frame_data([trobust.frame_data_from_numpy(f, "cpu") for f in prev])
    tcurr = stack_frame_data([trobust.frame_data_from_numpy(f, "cpu") for f in curr])
    res = batched_track_pair(tprev, tcurr, torch.tensor(scene["k"]), tcfg)

    if batch == "hard":
        assert calls["retrack"] > 0
        if hard_trips_trigger:
            assert calls["fallback"] > tcfg.levels
        else:
            assert calls["fallback"] == tcfg.levels
    else:
        assert calls["retrack"] == 0 and calls["fallback"] == 0
        assert (calls["stack"] > 0) == stack_on_easy
    np.testing.assert_array_equal(
        res.diagnostics.iterations.numpy(), ref.diagnostics.iterations
    )
    np.testing.assert_allclose(res.transform.numpy(), ref.transform, atol=ATOL)
    np.testing.assert_array_equal(res.success.numpy(), ref.success)
    assert res.success.all()
    np.testing.assert_allclose(res.diagnostics.count.numpy(), ref.diagnostics.count)
    np.testing.assert_allclose(res.diagnostics.scale.numpy(), ref.diagnostics.scale, rtol=1e-4)
    np.testing.assert_allclose(res.diagnostics.error.numpy(), ref.diagnostics.error, rtol=1e-4)
    np.testing.assert_allclose(
        res.hessian.numpy(), ref.hessian, rtol=1e-4, atol=1e-4 * np.abs(ref.hessian).max()
    )
    # Against the truth as well: the tracks are right, not only equal.
    for n, (i, j) in enumerate(BATCHES[batch]):
        if batch == "hard" and n == 0:
            continue
        gt = np.linalg.inv(scene["poses"][j]) @ scene["poses"][i]
        assert np.abs(res.transform[n].numpy() - gt).max() < 5e-3


@pytest.fixture(scope="module")
def fast_tier(scene):
    jcfg, tcfg = tier_configs("tpu_fast")
    return tcfg, jax_track(scene, jcfg)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_track_pair_matches_jax(scene, fast_tier, batch, monkeypatch):
    tcfg, ref = fast_tier
    check_track_pair(scene, tcfg, ref[batch], batch, monkeypatch)


def _blank_frames():
    return trobust.FrameData(
        gray=tuple(torch.zeros(1, 32 >> lv, 32 >> lv) for lv in range(4)),
        depth_m=tuple(torch.zeros(1, 32 >> lv, 32 >> lv) for lv in range(4)),
    )


@pytest.mark.parametrize("config_class", [JConfig, TConfig], ids=["jax", "port"])
def test_esm_on_an_unfrozen_fused_level_is_refused(config_class):
    """ESM gradients at a "fused" level are averaged into the frozen
    window's Jacobian planes: without ``freeze_shift_window`` both packages'
    configurations refuse them, so the tracker never meets that case."""
    data = {**json.loads((CONFIGS / "tpu_fast.json").read_text()),
            "use_esm_gradients": True, "freeze_shift_window": False}
    with pytest.raises(ValueError, match="requires freeze_shift_window"):
        config_class.from_dict(data)


@pytest.mark.parametrize(
    "change",
    [
        {"init_scale_ladder": (0.5,)}, {"lm_lambda0": None},
        {"use_fused_iteration": False}, {"shift_stack_levels": (0, 1)},
        {"shift_stack_levels": (0, 1, 2), "grid_strides": (2, 2, 1, 3)},
        {"grid_strides": (3, 2, 1, 1)}, {"grid_strides": (4, 2, 1, 1)},
        {"sigma": 1.0}, {"use_depth_residuals": True},
        {"recenter_blocks": 2}, {"recenter_blocks": 3, "shift_stack_radius_y": 2},
        {"recenter_blocks": 2, "recenter_col_blocks": 2, "recenter_center_bound": 20},
    ],
    ids=lambda d: "_".join(d),
)
def test_ported_branches_run(change):
    """Branches ported since the first slice run, on frames without valid
    depth (every element fails, nothing raises); strides 3 and 4 at a level
    kernel level, and a stride of 3 at a level off the kernels.
    ``tests/test_torch_strides.py`` holds the strides against the JAX
    package."""
    base = TConfig.from_json(CONFIGS / "tpu_fast.json").__dict__
    cfg = TConfig(**{**base, **change})
    frames = _blank_frames()
    res = trobust.track_pair(
        frames, frames, TCamera.create(np.eye(3), 1.0), cfg, init_guess=torch.eye(4)
    )
    assert res.transform.shape == (1, 4, 4) and not bool(res.success[0])
